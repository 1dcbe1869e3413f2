"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from adaptigraph_torch/kernels/csrc with
nvcc and drives the simulator frame through rollout_steps on five paths:
the rope at its 5,120-particle design point (2 substeps x 4 iterations, a
box pusher sweeping through the rope; K1 and K2), the same rope in the
sparse contact mode (its neighbor list from the hashed cell list; no
contact kernel), the granular design point (26,982 particles in a 32,768
cap, 12 substeps x 6 iterations, the board pushing the pile, shapes fused
into the sweep; K1 with K4, and K2), the granular dense band (1,866
particles; K3) and the cloth design point (4,900 particles, 4 substeps x
50 iterations, the sheet landing and the box pushing its edge; K1 200
times and K2 once a frame). It holds each kernel against its plain
PyTorch version (and K1 over full lists against K3; K2 also on its edge
cases: the design point after landing, a rope whose blocks are all
pruned, and synthetic lists with empty and full rows and stale slots; K1
and K2 on the cloth's frames), checks that two launches of each kernel on
the same inputs give the same bits, and holds frames on the card against
frames on the CPU (on the cloth, card frames with the springs or the
shapes left out must fail that gate). It then drives the learned step
(gnn_path) at the rope config's full width (nf 150, pstep 3, 100 objects
and one tool point, max_nR 1000; weights from a seed; no contact kernel
may launch): the entry's batch of 8 graphs in every aggregation mode and
in bfloat16, held against matmul on the card and the CPU's forward, and
the rollout evaluator over the rope main path's own push (its recorded
positions the object track, the box's centre the tool point), card
against CPU at every step, with its graph steps/s, launches a step and
device idle share. Then MPPI on the learned step (plan_path) at the rope
task's width (200 objects and the pusher, repeats to 15; 4,000 sampled
pushes in chunks of 2,500, 2 iterations) from the rope's last recorded
frame towards a target made from its middle frame: 3 samples held against
the CPU, the chunked population against one chunk, sample 0 of iteration
1 the incumbent, every action in the box, no contact kernel; with MPPI
samples/s, the chunk forward's time in each aggregation mode, the edge
rebuild, launches and idle share a repeat and the peak memory. Then the
simulator app (sim_path): one rope episode through sim.data_gen's
gen_episode at the data-gen config's full width (the rope at its cap of
3,072, the floor, two tables, the stick and the xArm6's 7 convex link
hulls, 4 cameras at 360 x 360; the settle, the push and the chunk count
cut, SIM_CUTS): K1 8 times and K2 once a frame; the episode read back
and preprocessed; K1 and K2 against their plain versions on a pushed
frame; card frames, the IK track and one frame rendered by the 4
cameras against the CPU's; its frames/s, launches a frame, the IK's
seconds and the render's ms. Between the episode's preprocessing and the
frame checks, training (train_path) on that episode at the rope dynamics
config's full width (nf 150, pstep 3, max_nobj 100, max_nR 1,000, B 128,
augment on; weights from the config's seed; train and valid both take
the one episode): one step's loss and every gradient leaf held against
the CPU's (B 8, the same params, batch and draws), the B 128 prepared
batch against the CPU's, train() through two K-step chunks on the
device-resident episode and a resume, and through its host loop (equal
bit for bit), the loss falling; train steps/s, the step's split
(prepare, forward + backward, Adam), launches, idle share and peak
memory; no contact kernel. Then the closed planning loop (loop_path):
planning.plan.plan() on SimPlanEnv, the sim path's scene, at the rope
task's full width (200 objects, the pcd target built from the card's own
first observation, the action box recentred on the rope; 2,500 sampled
pushes, 2 iterations, one action, the physics estimate refitted):
perceive, MPPI, push (K1 8 times and K2 once a frame), perceive, log,
refit; every perceived point near the rope, the chosen push's prediction
against the CPU's, the incumbent kept, the artefacts plan() writes; the
seconds an action takes in each stage. Then batched episodes
(batch_path): sim.batch_env.generate_batch over two rope episodes in
lockstep at the sim path's scene and cuts, one push each, env 0 the sim
path's own episode: both episodes written, read back and preprocessed,
env 0's settle and push equal to the sim path's lone run, no NaN flag,
K1 8 times and K2 once an env-frame; push frames/s summed over the envs,
the gate render's ms. Then the native host libraries (native_path):
native/fps.cpp and native/shm_ring.cpp built with the machine's g++,
FPS's index lists native against numpy on the sim path's rope, its 4
captured camera frames through a shared-memory ring from a second
process byte for byte, a RealEnv with its doubles (4 camera processes,
FakeXarm) read and pushed once, no segment left behind. Each phase
prints one JSON line. The last lines are
the kernel table, the card's name and power limit, and the result line
{"ok": true, "device": {...}}. Any failed phase, or the internal deadline,
exits non-zero without the result line. Without a CUDA device it fails at
once. Imports the standard library, numpy, torch and adaptigraph_torch
only.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

# kineto tears CUPTI down at the end of each torch.profiler session: left
# up, it slowed the process's later launches by 16-30% after one session
# (7-13% torn down; PERF.md)
os.environ.setdefault("TEARDOWN_CUPTI", "1")

import torch  # noqa: E402

DEVICE = "cuda:0"
DEADLINE_S = 300.0  # build plus every phase
T_MAIN = 80  # frames of the rope main-path rollout (the pusher's sweep)
T_PUSH = 30  # frames searched for the kernel checks' frame (rope meets floor)
T_BENCH = 20  # frames of bench.py's pinned rope (timed only; 80 before the
#               sim path took its time, 40 before the loop path did)
T_GRANULAR = 28  # granular design point frames (the pile lands at about
#                  frame 7; the board, at SimEnv's speed, reaches it at
#                  about frame 6 and is ~0.07 past its near face at the end;
#                  36 before the sim path took its time)
T_LANDED = 8  # the granular design point's first frame after landing:
#               AABB lists of up to 20 blocks a row tile (as at frame 36),
#               and no granule yet within the keep distance of another
T_DENSE = 10  # dense band frames (the pile lands at about frame 7)
# frames in each window of the granular frame agreement (free fall and
# contacts, on the dense band and a block-mode scene; 3 before the loop
# path took its time: the CPU's frames there took ~60 s of the smoke, 2
# before the train path took its time: ~44 s)
GRANULAR_WINDOW = 1
# the granular design point as it must come out of the builder
DESIGN = {"n_active": 26982, "cap": 32768, "tile_j": 256}
K1_ATOL = 2e-5  # tests/test_pallas_kernels.py's tolerance for the sweeps
FRAME_ATOL = 1e-4  # card vs CPU positions, 3 frames from the built scene
# card vs CPU over 3 frames with contacts (see the frame_agreement phase):
# the median particle to 1e-5, every particle to a tenth of the contact
# distance
CONTACT_MEDIAN_ATOL, CONTACT_MAX_FRAC = 1e-5, 0.1
# the granular and cloth windows with contacts: the median particle to
# this many times the CPU's own median spread under a 1e-6 nudge of its
# input (see the granular_frame_agreement and cloth_frame_agreement
# phases)
MEDIAN_X_NUDGED = 3.0
T_CLOTH = 21  # cloth design point frames: the sheet lands at frame 8, the
#               box meets its edge at about frame 15 and pushes it from
#               there (24 before the loop path took its time)
T_CLOTH_LANDED = 12  # the cloth's kernel checks: a frame after landing
CLOTH_DESIGN = {"n_active": 4900, "offsets": (1, 70, 69, 71, 2, 140),
                "tile_j": 128, "blocks": (39, 39)}
# the landed sheet has no particle contacts (its unfiltered pairs sit at
# 1.11x the contact distance): K1 is also held on the frame's inputs with
# x and z jittered by up to this much, which brings pairs into contact
CLOTH_JITTER = 0.01
# the cloth window is one frame, the box pushing the landed sheet: the
# median particle to MEDIAN_X_NUDGED times the CPU's nudged median spread,
# every particle to MAX_X_NUDGED times the CPU's nudged max spread. On a
# CPU the nudge moved the median particle by 0.1e-6 to 0.9e-6 (frames
# 16-22) and the most-moved one by 4e-6 to 8e-5, where the box moves
# 3.3e-3 a frame (BOARD_SPEED)
MAX_X_NUDGED = 10.0
T_SPARSE = 6  # the rope at 5,120 particles in sparse mode (the cell list)
# the simulator app (sim_path): one episode through sim.data_gen.gen_episode
# on configs/data_gen/rope.yaml at its full width (the rope at its cap of
# 3,072, the floor, two tables, the stick and the xArm6's 7 link hulls, 4
# cameras at 360 x 360), its depth cut to SIM_CUTS: a 40-frame settle, 4
# chunks of 40 frames, the robot at 1/30 a frame (the config's 1/300 would
# not reach the rope in 120 frames), one push. Episode SIM_SEED (2,898
# particles): its first push starts 5.1 from the arm's base and its stick
# meets the rope at about push frame 32; episode 0's starts 7.5 away, out
# of the arm's reach, where the JAX package's own IK track jumps to
# another branch under a 1e-7 nudge (ROADMAP Queue 3), so no two
# arithmetics agree on it. The IK runs on the card and the CPU over the
# push's scripted track, the joints held over its first SIM_IK_FRAMES
# frames to SIM_IK_ATOL or MEDIAN_X_NUDGED times the CPU's own spread under
# a 1e-7 nudge of the start joints, whichever is larger; one pushed frame
# is rendered on both, float frames held off the depth silhouettes
# (render.silhouette_pixels) to SIM_RENDER_ATOL times the larger of 1 and
# the value: colours in [0, 1] to 1e-5, depths (up to ~20 here) to 1e-5 of
# themselves, about 10 float32 ulps (the card's matmuls and fused
# multiply-adds round the ray directions differently from the CPU's, and a
# depth of 15 carries that rounding times 15)
SIM_CUTS = {"settle_steps": 40, "max_chunks": 4, "robot_speed_inv": 30,
            "n_timestep": 1}
SIM_SEED = 3
SIM_IK_FRAMES, SIM_IK_ATOL, SIM_RENDER_ATOL = 120, 5e-5, 1e-5
SIM_PROFILE_FRAMES = 1  # push frames under torch.profiler (3 before the
#                         loop path took its time)
# the learned step (gnn_path): weights from GNN_SEED; each aggregation
# mode on the card against matmul on the card to GNN_MODE_ATOL (the JAX
# tests hold segment against matmul at 1e-4); the card's matmul forward
# against the CPU's to GNN_CPU_ATOL, or 3x the CPU's own float32 rounding
# (its float32 forward against its float64 one) where that is larger: the
# entry batch's random weights predict motions up to ~15, where 1e-5 is
# ten float32 ulps; bfloat16 compute within GNN_BF16_BOUND of the float32
# motion's scale (tests/test_dynamics.py:279 at nf 150); the rollout's
# per-step errors card against CPU to GNN_ERR_ATOL and its edges equal
# (where the CPU itself moves by more under a GNN_NUDGE nudge of the start
# state, to MEDIAN_X_NUDGED times that spread over the steps on which the
# nudged CPU run keeps its edges), at most GNN_STEPS steps
GNN_SEED = 1
GNN_MODE_ATOL, GNN_CPU_ATOL, GNN_BF16_BOUND = 1e-4, 1e-5, 0.08
GNN_ERR_ATOL, GNN_NUDGE, GNN_STEPS = 1e-5, 1e-6, 12  # 20 before the loop
#                                                     path took its time
# the planning path (plan_path): MPPI at the rope task's full width
# (configs/planning/rope.yaml with configs/dynamics/rope.yaml's model, 200
# objects + the 1-point pusher, repeats 5-15, weights from GNN_SEED):
# PLAN_SAMPLES sampled pushes in the config's chunks of 2,500 (the config
# plans 20,000; tools/profile_plan.py runs that), PLAN_ITERS MPPI
# iterations, proposals drawn from PLAN_SEED on the card. PLAN_CPU_SAMPLES
# samples (the first, the best, the last) are rolled again on the CPU from
# the same draws: their states and reward parts within PLAN_ATOL of the
# card's, or MEDIAN_X_NUDGED times the CPU's own spread under a GNN_NUDGE
# nudge of the state where that is larger; the whole population in one
# chunk within the same bound of the chunked one
PLAN_SAMPLES, PLAN_ITERS, PLAN_SEED, PLAN_CPU_SAMPLES = 4000, 2, 0, 3
PLAN_ATOL = 1e-5
# the closed planning loop (loop_path): planning.plan.plan() on SimPlanEnv
# at the rope's full width, the sim path's scene (configs/data_gen/rope.yaml
# at SIM_CUTS, episode SIM_SEED: the rope at its 3,072 cap, 11 shape slots,
# 4 cameras at 360 x 360) and configs/planning/rope.yaml's task (max_nobj
# 200, max_nR 2,000, the pcd target, the rope penalty, reward_weight 500),
# the model from GNN_SEED's weights. The target: the first observation's
# cloud (host FPS to at most 2 x max_nobj points) moved by LOOP_SHIFT in
# the plan frame, then mirrored back to the flex frame and divided by
# sim_real_ratio, as plan() reads a pcd target
# (scripts/plan_acceptance.py:136-180 builds its targets so); the action
# box and the workspace bbox recentred on the rope
# (scripts/plan_acceptance.py:189-215). Cut: LOOP_SAMPLES sampled pushes
# (one chunk) of the config's 20,000, PLAN_ITERS iterations,
# LOOP_ACTIONS of the config's 10 actions, the physics estimate refitted
# with LOOP_PPO_ITERS GP evaluations (the default 50), the push at
# SIM_CUTS. Proposals drawn from LOOP_SEED: the weights are random, so
# whether the chosen push meets the rope is the draws' luck; at seed 11 the
# card's first push crosses the rope (at seed 0 it stops short of it).
# Gates: every perceived point within LOOP_PERCEIVE_DIST of an active rope
# particle (tests/test_pipeline_e2e.py's bound), 1 to max_nobj nodes; the
# chosen push's predicted state and reward parts against the CPU's
# (PLAN_ATOL, or MEDIAN_X_NUDGED times the CPU's nudged spread); the
# perceived cloud moved by LOOP_MOVED (chamfer) over the loop, and some
# rope particle by LOOP_PUSHED (the sim path's bound: the push met the
# rope)
LOOP_SAMPLES, LOOP_ACTIONS, LOOP_PPO_ITERS, LOOP_SEED = 2500, 1, 4, 11
LOOP_SHIFT = (0.5, 0.0, 0.0)
LOOP_PERCEIVE_DIST, LOOP_MOVED, LOOP_PUSHED = 0.5, 1e-3, 0.05
# training (train_path): configs/dynamics/rope.yaml at its full width (nf
# 150, pstep 3, max_nobj 100, max_nR 1,000, n_his 4, n_future 3, matmul
# aggregation, batch 128, augment on with state noise 0.05) on the sim
# path's own preprocessed episode (its frame pairs; the config's
# ratio.train [0, 0.98] keeps no episode of one, so train and valid both
# take [0, 1]); weights from the config's seed. TRAIN_K steps a chunk.
# Gates: one step's loss and every gradient leaf card against CPU on
# TRAIN_GRAD_B graphs from the same params, batch and draws, within
# TRAIN_GRAD_RTOL of the leaf's largest entry (the loss relative to
# itself); the B 128 prepared batch on the card equal to the CPU's from
# the same draws; train() through two K-step chunks (2 epochs of K train
# and K valid steps), the second epoch's mean train loss below the
# first's, `latest` read back equal, resume=True to a third epoch; the
# same two epochs through train()'s host loop, its losses and params equal
# to the chunk path's bit for bit; no contact kernel. TRAIN_TIME_CHUNKS
# chunks timed for steps/s, TRAIN_SPLIT_STEPS steps split by CUDA events,
# one step under torch.profiler.
TRAIN_K, TRAIN_GRAD_B, TRAIN_GRAD_RTOL = 8, 8, 1e-5
TRAIN_TIME_CHUNKS, TRAIN_SPLIT_STEPS = 3, 3
# batched episodes (batch_path): sim.batch_env.generate_batch over
# BATCH_SEEDS, one push each (n_timestep 1), at the sim path's scene
# (configs/data_gen/rope.yaml at SIM_CUTS: the rope at its 3,072 cap, 11
# shape slots, 4 cameras at 360 x 360). Env 0 takes the sim path's episode
# SIM_SEED, so the sim path's own run is the lone SimEnv it is held to: its
# settled positions and its first push's chunk-end records equal
# (torch.equal) where the batch re-padded nothing, within BATCH_ATOL where
# it re-padded env 0's spec. Seed 74 (2,730 particles): its trimmed
# cluster matrix (24 rows) and incidence tables are no wider than seed 3's,
# so nothing is re-padded; its first push starts 3.6 from the arm's base
# and, like seed 3's, needs 3 of the 4 chunks (seed 7's needed all 4: 80
# more env-frames a batch)
BATCH_SEEDS, BATCH_ATOL = (SIM_SEED, 74), 1e-4
# the native host libraries (native_path): FPS's index lists on the sim
# path's settled rope, native against numpy (NATIVE_FPS_N points from
# index 0; the radius form at NATIVE_FPS_RADIUS from a RandomState(0)
# start); the sim path's 4 captured camera frames through a shared-memory
# ring from a second process, equal byte for byte; a RealEnv with its
# doubles (4 camera processes, FakeXarm) at the sim path's 360 x 360, its
# frames aligned within NATIVE_MAX_SKEW s, one push through FakeXarm
NATIVE_FPS_N, NATIVE_FPS_RADIUS, NATIVE_MAX_SKEW = 500, 0.2, 0.1
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_S = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations a pair costs: detection (differences, squares, sums,
# the compares) on every pair the function must test (K1 and K3 every
# listed pair, K2 the listed pairs within its keep distance: near_pairs),
# projection on every contact pair
DETECT_OPS, PROJECT_OPS = 26, 52
# float32 operations K4's stage spends on one particle against one valid
# shape, by kind (engine/state.py: 0 box, 1 capsule, 2 plane; a convex
# shape adds 12 per plane to the plane's count): the local point (18), the
# kind's distance and normal (box 31, capsule 16, plane 0), the world
# normal (15) and the contact and friction update (51). The rotation
# matrix, the same for every particle, is not counted.
SHAPE_OPS = {0: 115, 1: 100, 2: 84, 3: 84}
SHAPE_OPS_PER_PLANE = 12
# K4's shape sets (make_shapes' arguments, its slot count m_max and the
# slots the stage takes): tests/test_pallas_kernels.py's four kinds (a
# plane, a box, a capsule and a convex tetrahedron), and seven slots for
# the stage's lane split at a count that is not a multiple of its 4 lanes
# (lanes 0-2 take two shapes, lane 3 one): the four, a second box, a
# convex cube (6 planes; the tetrahedron's row is padded with 2 empty
# ones) and an invalid padding slot
TETRA = [[1, 0, 0, 0.2], [0, 1, 0, 0.2], [0, 0, 1, 0.2],
         [-0.577, -0.577, -0.577, 0.1]]
CUBE = [[1, 0, 0, 0.12], [-1, 0, 0, 0.12], [0, 1, 0, 0.12],
        [0, -1, 0, 0.12], [0, 0, 1, 0.12], [0, 0, -1, 0.12]]
FOUR_KINDS = dict(
    kinds=[2, 0, 1, 3],
    sizes=[[0, 0, 0], [0.3, 0.2, 0.3], [0.1, 0.3, 0], [0, 0, 0]],
    poses=[[0, 0, 0], [0.2, 0.15, 0.0], [-0.3, 0.2, 0.1], [0.1, 0.1, -0.2]],
    quats=[[0, 0, 0, 1], [0.1, 0.2, 0.0, 0.97], [0, 0, 0.38, 0.92],
           [0.2, 0, 0.1, 0.97]],
    planes=[None, None, None, TETRA], m_max=5, active=4)
SEVEN_SLOTS = dict(
    kinds=FOUR_KINDS["kinds"] + [0, 3],
    sizes=FOUR_KINDS["sizes"] + [[0.2, 0.1, 0.25], [0, 0, 0]],
    poses=FOUR_KINDS["poses"] + [[-0.3, 0.8, -0.3], [0.35, 0.6, 0.35]],
    quats=FOUR_KINDS["quats"] + [[0.0, 0.3, 0.1, 0.95], [0.1, 0.1, 0.0, 0.99]],
    planes=FOUR_KINDS["planes"] + [None, CUBE], m_max=8, active=7)

_phase = ["start"]


_T0 = time.perf_counter()


def emit(obj):
    """Print obj as one JSON line; a phase's line also carries at_s, the
    seconds since the smoke started."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _T0, 2)}
    print(json.dumps(obj), flush=True)


def watchdog():
    def fire():
        print(json.dumps({"phase": _phase[0], "ok": False,
                          "error": f"deadline of {DEADLINE_S} s passed"}),
              flush=True)
        os._exit(3)

    t = threading.Timer(DEADLINE_S, fire)
    t.daemon = True
    t.start()


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=15)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
            "nvidia-smi printed nothing: " + out.stderr.strip())
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def repeats(fn):
    """Whether two launches of fn on the same inputs give the same bits
    (the sweeps add their sums in a fixed order, with no atomics)."""
    first, second = fn(), fn()
    return all(torch.equal(x, y) for x, y in zip(first, second))


def event_ms(fn, reps, warm=3):
    """Mean device time of one call of fn, from CUDA events around reps
    back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def block_tables(p, spec, tile_j):
    """The block sweep's contact tables of particles `p` at `tile_j`."""
    from adaptigraph_torch.engine import contact_kernels as ck

    return ck.pack_contact_tables(p.pos, p.pos, p.group, p.inv_mass,
                                  p.self_collide, p.active, spec.rest_pos,
                                  tile_j=tile_j)


def kernel_inputs(state, spec, tile_j, granular_groups=False, substeps=2):
    """The mid-push frame's inputs to K2 and K1, built as xpbd_step builds
    them: tables, AABB block lists and keep distance at the frame start,
    then the positions the first solver iteration sees (one substep of
    free flight, a frame of `substeps`). `granular_groups` gives every 128
    particles (one row tile) a group of its own, as a granular scene gives
    every granule one, so that the kernels' rest_filter=False form, which
    the rope never takes, meets contacts: between tiles only, so K2 keeps
    a tile's neighbour blocks and drops its own, and its compaction
    reorders."""
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.solver import frame_block_lists

    p, prm, sh = state.particles, spec.params, state.shapes
    if granular_groups:
        grp = torch.arange(p.pos.shape[0], device=p.pos.device) // 128
        p = p._replace(group=grp.to(torch.int32))
    rows, cols = block_tables(p, spec, tile_j)
    s_vel = (sh.pos - sh.prev_pos) / prm.dt
    idx, cnt, overflow, keep = frame_block_lists(p, spec, s_vel, tile_j)
    dt = prm.dt / substeps
    mov = ((p.inv_mass > 0) & p.active).to(torch.float32)[:, None]
    vel = p.vel.clone()
    vel[:, 1] += prm.gravity * dt
    pred = p.pos + vel * mov * dt
    rows1, cols1 = ck.update_contact_tables(rows.clone(), cols.clone(), pred,
                                            pos_prev=p.pos)
    return dict(rows=rows, cols=cols, idx=idx, cnt=cnt, keep=keep,
                overflow=int(overflow), rows1=rows1, cols1=cols1, prm=prm,
                n=p.pos.shape[0])


def frame_contacts(state, spec):
    """Particle contacts K1 meets in the frame's first solver iteration."""
    from adaptigraph_torch.engine import contact_kernels as ck

    a = kernel_inputs(state, spec, 128)
    prm = a["prm"]
    idx, cnt = ck.refine_blocks_plain(a["rows"], a["cols"], a["keep"],
                                      prm.collide_filter_dist, a["idx"],
                                      a["cnt"])
    _, c = ck.block_sparse_contact_plain(
        a["n"], a["rows1"], a["cols1"], prm.solid_rest_distance,
        prm.particle_friction, prm.collide_filter_dist, idx, cnt)
    return int(c.sum())


def edge_block_lists(nb, nb_j, maxb, seed=0):
    """Synthetic K2 lists for nb row tiles over nb_j col blocks, numpy int32
    (block_idx (nb, maxb), block_cnt (nb,)): tile i lists no block when
    i % 3 == 0, maxb blocks when i % 3 == 1, and a count in between
    otherwise. Each row holds distinct blocks in a random order, and the
    slots at or past its count hold stale ones: K2 must carry them to the
    back in slot order and never read their blocks."""
    rng = np.random.RandomState(seed)
    idx = np.argsort(rng.rand(nb, nb_j), axis=1)[:, :maxb].astype(np.int32)
    mid = rng.randint(1, max(maxb, 2), nb)
    cnt = np.where(np.arange(nb) % 3 == 0, 0,
                   np.where(np.arange(nb) % 3 == 1, maxb, mid))
    return idx, np.minimum(cnt, maxb).astype(np.int32)


def near_pairs(rows, cols, keep_dist, block_idx, block_cnt, tile_j):
    """K2's listed pairs of two active particles closer than keep_dist, by
    the plain version's distance test: the pairs whose detection no
    culling by distance can skip, whatever the scan order. Pairs farther
    apart need no test of their own (K2 culls them by groups), so they are
    not counted in its bound."""
    from adaptigraph_torch.engine import contact_kernels as ck

    nb = block_idx.shape[0]
    r = rows.view(nb, ck.TILE, 16)
    keep = torch.as_tensor(keep_dist, dtype=torch.float32, device=rows.device)
    total = 0
    for k in range(int(block_cnt.max()) if nb else 0):
        c = ck._gather_blocks(cols, block_idx, k, tile_j)
        d2 = sum((r[..., a:a + 1] - c[:, a:a + 1, :]) ** 2 for a in range(3))
        near = ((d2 < keep * keep) & (d2 > 1e-14) & (r[..., 12:13] > 0.5)
                & (c[:, 12:13, :] > 0.5))
        total += int(near[block_cnt > k].sum())
    return total


def reset_counts():
    """Every launch count, and the unfused shape pass's call count, to 0."""
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.collisions import shape_contact_deltas

    k1 = ck.block_sparse_contact_deltas_packed
    k1.launches = k1.fused_launches = 0
    ck.refine_overlap_blocks_packed.launches = 0
    ck.dense_contact_deltas_packed.launches = 0
    shape_contact_deltas.calls = 0


def read_counts():
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.collisions import shape_contact_deltas

    k1 = ck.block_sparse_contact_deltas_packed
    return {"k1": k1.launches, "k4": k1.fused_launches,
            "k2": ck.refine_overlap_blocks_packed.launches,
            "k3": ck.dense_contact_deltas_packed.launches,
            "unfused_shape_pass": shape_contact_deltas.calls}


def shape_ops(shp, planes2d):
    """K4's float32 operations per particle for these shape rows (valid
    shapes only)."""
    n_planes = 0 if planes2d is None else planes2d.shape[0] // shp.shape[0]
    ops = 0
    for kind, valid in shp[:, :2].tolist():
        if valid > 0.5:
            ops += SHAPE_OPS[int(kind)] + (
                SHAPE_OPS_PER_PLANE * n_planes if int(kind) == 3 else 0)
    return ops


def bound(nbytes, ops):
    """(ms, what bounds it): the larger of bytes over the HBM rate and
    float32 operations over the float32 rate."""
    tb, to = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def shape_case(dev, tile_j, shapes=FOUR_KINDS):
    """tests/test_pallas_kernels.py's fused-stage inputs on the card: its
    256 particles against a shape set (FOUR_KINDS, its own, or
    SEVEN_SLOTS): (rows, cols, block lists, shp, planes2d,
    shape_params)."""
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.state import make_shapes

    rng = np.random.RandomState(3)
    n = 256
    pos = (rng.rand(n, 3).astype(np.float32) * 1.2
           - np.array([0.6, 0.0, 0.6], np.float32))
    prev = pos - rng.randn(n, 3).astype(np.float32) * 0.01
    sh = make_shapes(shapes["kinds"], shapes["sizes"], shapes["poses"],
                     shapes["quats"], m_max=shapes["m_max"],
                     planes=shapes["planes"], device=dev)
    s_vel = torch.as_tensor(
        rng.randn(shapes["m_max"], 3).astype(np.float32) * 0.05, device=dev)
    a = shapes["active"]
    shp = torch.cat([sh.kind[:a, None].float(), sh.valid[:a, None].float(),
                     sh.size[:a], sh.pos[:a], sh.quat[:a], s_vel[:a],
                     torch.zeros((a, 1), device=dev)], 1).contiguous()
    planes2d = sh.planes[:a].reshape(-1, 4).contiguous()

    def t(x):
        return torch.as_tensor(x, device=dev)

    rows, cols = ck.pack_contact_tables(
        t(pos), t(prev), t((np.arange(n) // 16).astype(np.int32)),
        t(np.ones(n, np.float32)), t(np.zeros(n, bool)), t(np.ones(n, bool)),
        t(rng.rand(n, 3).astype(np.float32)), tile_j=tile_j)
    n_pad = cols.shape[1]
    idx, cnt, _ = ck.tile_overlap_blocks(
        cols[0:3].T.contiguous(), cols[12] > 0.5,
        torch.tensor(0.05 * 1.5, device=dev), tile_j=tile_j)
    return dict(n=n, n_pad=n_pad, rows=rows, cols=cols, idx=idx, cnt=cnt,
                shp=shp, planes2d=planes2d, scal=(0.05, 0.25, 0.0),
                shape_params=(0.04, 0.0, 0.3, 1.0 / 60))


def fused_vs_unfused(a, rest_filter, tile_j):
    """Fused K1 (K4) against the unfused K1 plus shape_stage_plain on the
    same inputs, and the unfused K1 against its plain version (the fused
    and unfused launches share the pair sweep, so only the plain version
    can catch a fault in it). Returns the report (counts equal, max |delta
    error| of each comparison, particle and shape contacts)."""
    from adaptigraph_torch.engine import contact_kernels as ck

    n = a["n"]
    args = (n, a["rows"], a["cols"], *a["scal"], a["idx"], a["cnt"])
    kw = dict(rest_filter=rest_filter, tile_j=tile_j)
    d1, c1 = ck.block_sparse_contact_deltas_packed(
        *args, shp=a["shp"], planes2d=a["planes2d"],
        shape_params=a["shape_params"], **kw)
    d0, c0 = ck.block_sparse_contact_deltas_packed(*args, **kw)
    fused_again = repeats(lambda: ck.block_sparse_contact_deltas_packed(
        *args, shp=a["shp"], planes2d=a["planes2d"],
        shape_params=a["shape_params"], **kw))
    unfused_again = repeats(
        lambda: ck.block_sparse_contact_deltas_packed(*args, **kw))
    pd, pc = ck.block_sparse_contact_plain(*args, **kw)
    ds, cs = ck.shape_stage_plain(a["rows"][:n, 0:3], a["rows"][:n, 3:6],
                                  a["shp"], a["planes2d"], *a["shape_params"])
    per_shape = []
    for k in range(a["shp"].shape[0]):
        pl = (None if a["planes2d"] is None else
              a["planes2d"].view(a["shp"].shape[0], -1, 4)[k])
        per_shape.append(int(ck.shape_stage_plain(
            a["rows"][:n, 0:3], a["rows"][:n, 3:6], a["shp"][k:k + 1], pl,
            *a["shape_params"])[1].sum()))
    return {"tile_j": tile_j, "rest_filter": rest_filter,
            "counts_equal": bool(torch.equal(c1, c0 + cs)),
            "max_abs_err": float((d1 - (d0 + ds)).abs().max()),
            "k1_counts_equal": bool(torch.equal(c0, pc)),
            "k1_max_abs_err": float((d0 - pd).abs().max()),
            "particle_contacts": int(pc.sum()),
            "shape_contacts": int(cs.sum()),
            "shape_contacts_by_slot": per_shape,
            "valid_slots": [v > 0.5 for v in a["shp"][:, 1].tolist()],
            "fused_repeats_bitwise": fused_again,
            "unfused_repeats_bitwise": unfused_again,
            "finite": bool(torch.isfinite(d1).all())}


def k2_edges(cases):
    """K2 on the card against refine_blocks_plain, `torch.equal` on lists
    and counts, and two launches for equal bits, over `cases`: (name, K2's
    inputs (rows, cols, keep_dist, filter_dist, block_idx, block_cnt),
    tile_j, rest_filter). Returns the report of each case."""
    from adaptigraph_torch.engine import contact_kernels as ck

    report = []
    for name, args, tile_j, rf in cases:
        kw = dict(rest_filter=rf, tile_j=tile_j)
        n = args[0].shape[0]
        ki, kc = ck.refine_overlap_blocks_packed(n, *args, **kw)
        pi, pc = ck.refine_blocks_plain(*args, **kw)
        cnt, maxb = args[5], args[4].shape[1]
        report.append({
            "case": name, "tile_j": tile_j, "rest_filter": rf,
            "equal": bool(torch.equal(ki, pi) and torch.equal(kc, pc)),
            "repeats_bitwise": repeats(
                lambda: ck.refine_overlap_blocks_packed(n, *args, **kw)),
            "row_tiles": int(cnt.shape[0]), "maxb": maxb,
            "tiles_listing_none": int((cnt == 0).sum()),
            "tiles_listing_maxb": int((cnt == maxb).sum()),
            "listed": int(cnt.sum()), "max_blocks_per_tile": int(cnt.max()),
            "kept": int(pc.sum())})
    return report


def k1_k2_times(dev, lib, a, k1_args, k2_args, tile_j, rest_filter):
    """K1's and K2's times on one frame's inputs (kernel_inputs' `a`, with
    K1's arguments over K2's refined lists): raw launches and the plain
    versions in turns, with each one's bound (bytes it must move, or
    float32 operations on the pairs this frame's data needs) and launch
    geometry."""
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.kernels import build

    n, prm = a["n"], a["prm"]
    kw = dict(rest_filter=rest_filter, tile_j=tile_j)
    stream = torch.cuda.current_stream().cuda_stream
    n_pad = a["cols"].shape[1]
    pi, pc = k1_args[-2:]
    nb, maxb = pi.shape
    s1 = ck.device_scalars(dev, *k1_args[3:6])
    s2 = ck.device_scalars(dev, a["keep"], prm.collide_filter_dist)
    delta = torch.empty((n, 3), device=dev)
    count = torch.empty((n,), device=dev)
    new_idx, new_cnt = torch.empty_like(a["idx"]), torch.empty_like(a["cnt"])
    k1_ptrs = [t.data_ptr() for t in (a["rows1"], a["cols1"], pi, pc, s1,
                                      delta, count)]
    k2_ptrs = [t.data_ptr() for t in (a["rows"], a["cols"], a["idx"],
                                      a["cnt"], s2, new_idx, new_cnt)]

    def k1_raw():
        build.check(lib, lib.ag_block_sparse_contact(
            *k1_ptrs, n, n_pad, maxb, tile_j, int(rest_filter), stream), "K1")

    def k2_raw():
        build.check(lib, lib.ag_refine_blocks(
            *k2_ptrs, n_pad, maxb, tile_j, int(rest_filter), stream), "K2")

    times = {
        "k1_plain_a": event_ms(
            lambda: ck.block_sparse_contact_plain(*k1_args, **kw), 10),
        "k1": event_ms(k1_raw, 200), "k1_b": event_ms(k1_raw, 200),
        "k1_plain_b": event_ms(
            lambda: ck.block_sparse_contact_plain(*k1_args, **kw), 10),
        "k2_plain_a": event_ms(lambda: ck.refine_blocks_plain(*k2_args, **kw),
                               10),
        "k2": event_ms(k2_raw, 200), "k2_b": event_ms(k2_raw, 200),
        "k2_plain_b": event_ms(lambda: ck.refine_blocks_plain(*k2_args, **kw),
                               10)}
    contacts = int(ck.block_sparse_contact_plain(*k1_args, **kw)[1].sum())
    pairs1 = int(pc.sum()) * ck.TILE * tile_j
    near2 = near_pairs(a["rows"], a["cols"], a["keep"], a["idx"], a["cnt"],
                       tile_j)
    table_bytes = 2 * n_pad * 16 * 4
    list_bytes = (nb * maxb + nb) * 4
    k1_bytes = table_bytes + list_bytes + 3 * 4 + n * 4 * 4
    k2_bytes = table_bytes + 2 * list_bytes + 2 * 4
    k1_ops = DETECT_OPS * pairs1 + PROJECT_OPS * contacts
    k2_ops = DETECT_OPS * near2
    return {
        "times": times,
        "k1_bound": bound(k1_bytes, k1_ops), "k2_bound": bound(k2_bytes, k2_ops),
        "geometry": {"k1": build.launch_geometry(lib, "k1", n_pad, maxb),
                     "k2": build.launch_geometry(lib, "k2", n_pad, maxb)},
        "detail": {
            "k1": {"listed_blocks": int(pc.sum()), "pairs": pairs1,
                   "contacts": contacts, "bytes": k1_bytes, "ops": k1_ops},
            "k2": {"listed_blocks": int(a["cnt"].sum()),
                   "max_blocks_per_tile": int(a["cnt"].max()),
                   "listed_pairs": int(a["cnt"].sum()) * ck.TILE * tile_j,
                   "near_pairs": near2, "bytes": k2_bytes, "ops": k2_ops}}}


def granular_phases(dev, lib):
    """The granular design point and its dense band on the card. Returns
    what the kernel table needs: launches, errors, times and bounds."""
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.collisions import (
        shape_contact_deltas, shape_sdf)
    from adaptigraph_torch.engine.solver import (
        _shape_table, auto_contact_mode, auto_tile_j, frame_block_lists,
        rollout_steps)
    from adaptigraph_torch.engine.state import tree_to
    from adaptigraph_torch.kernels import build
    from adaptigraph_torch.scenes import design_point as dp

    out = {}
    # the design point, built as SimEnv builds it
    _phase[0] = "granular_scene"
    t0 = time.perf_counter()
    g = dp.granular_scene(device=dev)
    gp, spec = g.state.particles, g.spec
    n = gp.pos.shape[0]
    # SimEnv's rule: no self-colliding particle, no rest filter
    rest_filter = bool(gp.self_collide[: g.n_active].any())
    tj = auto_tile_j(n)
    s_vel0 = (g.state.shapes.pos - g.state.shapes.prev_pos) / spec.params.dt
    idx0, cnt0, ov0, _ = frame_block_lists(gp, spec, s_vel0, tj)
    n_shapes = int(g.state.shapes.kind.shape[0])  # SimEnv's caps.m
    caps = {"n": n, "c": int(spec.clusters.member.shape[0]),
            "k": int(spec.clusters.member.shape[1]), "m": n_shapes}
    info = {"phase": "granular_scene", "n_active": g.n_active, "caps": caps,
            "granules": int(spec.clusters.valid.sum()),
            "contact_mode": auto_contact_mode(n), "tile_j": tj,
            "rest_filter": rest_filter, "maxb": int(idx0.shape[1]),
            "row_tiles": int(idx0.shape[0]),
            "listed_blocks": int(cnt0.sum()),
            "max_blocks_per_tile": int(cnt0.max()), "overflow": int(ov0),
            "segments": spec.cluster_seg is not None,
            "substeps": g.substeps, "iterations": g.iterations,
            "seconds": time.perf_counter() - t0}
    ok = (g.n_active == DESIGN["n_active"] and n == DESIGN["cap"]
          and tj == DESIGN["tile_j"]
          and not rest_filter and int(ov0) == 0
          and spec.cluster_seg is not None)
    emit({**info, "ok": ok})
    if not ok:
        raise RuntimeError("the granular design point is not as expected")

    # the main path: rollout_steps with the shapes fused into the sweep
    _phase[0] = "granular_path"
    ptj, qtj = dp.board_sweep(g, T_GRANULAR)
    kw = dict(rest_filter=rest_filter, n_shapes_active=n_shapes)
    rollout_steps(g.state, spec, ptj[:2], qtj[:2], g.substeps, g.iterations,
                  record=False, **kw)  # warm-up

    def path():  # in two calls, to keep the state of the landed frame
        landed, _ = rollout_steps(g.state, spec, ptj[:T_LANDED],
                                  qtj[:T_LANDED], g.substeps, g.iterations,
                                  record=False, **kw)
        return landed, rollout_steps(
            landed, spec, ptj[T_LANDED:], qtj[T_LANDED:], g.substeps,
            g.iterations, record=False, **kw)[0]

    reset_counts()
    (landed, final), secs = sync_time(path)
    counts = read_counts()
    fp = final.particles
    act = fp.active
    sd, _ = shape_sdf(fp.pos[act], final.shapes.kind, final.shapes.size,
                      final.shapes.pos, final.shapes.quat)
    board_touching = int((sd[3] < spec.params.collision_distance).sum())
    # the board meets the pile: particles it pushed along +z
    pushed = int(((fp.pos - gp.pos)[act][:, 2] > 0.05).sum())
    iters = g.substeps * g.iterations
    overflow = int(final.contact_overflow)
    finite = bool(torch.isfinite(fp.pos).all())
    emit({"phase": "granular_path", "frames": T_GRANULAR, "seconds": secs,
          "frames_per_s": T_GRANULAR / secs,
          "ms_per_frame": 1e3 * secs / T_GRANULAR, "launches": counts,
          "launches_per_frame": {k: v / T_GRANULAR
                                 for k, v in counts.items()},
          "contact_overflow": overflow, "finite": finite,
          "particles_touching_board": board_touching,
          "particles_pushed_0.05_along_z": pushed,
          "max_displacement": float((fp.pos - gp.pos).abs().max())})
    if (counts["k1"] != iters * T_GRANULAR or counts["k4"] != counts["k1"]
            or counts["k2"] != T_GRANULAR or counts["k3"] != 0
            or counts["unfused_shape_pass"] != 0 or overflow != 0
            or not finite or pushed == 0):
        raise RuntimeError("granular main path check failed")
    out["granular_counts"] = counts
    la = kernel_inputs(landed, spec, tj)
    out["k2_landed_args"] = (la["rows"], la["cols"], la["keep"],
                             spec.params.collide_filter_dist, la["idx"],
                             la["cnt"])

    # K4: fused K1 against the unfused K1 plus shape_stage_plain
    _phase[0] = "k4_check"
    cases, k4_err = [], 0.0
    for (name, shapes), tile_j, rf in itertools.product(
            (("four_kinds", FOUR_KINDS), ("seven_slots", SEVEN_SLOTS)),
            (128, 256), (True, False)):
        r = fused_vs_unfused(shape_case(dev, tile_j, shapes), rf, tile_j)
        cases.append({"scene": name, **r})
    # the design point's last frame: the pile on the table, the board in
    # it; K2 on the card against its plain version on the frame's lists
    prm = spec.params
    sh = final.shapes
    s_vel = (sh.pos - sh.prev_pos) / prm.dt
    rows, cols = block_tables(fp, spec, tj)
    idx, cnt, _, keep = frame_block_lists(fp, spec, s_vel, tj)
    k2_args = (rows, cols, keep, prm.collide_filter_dist, idx, cnt)
    ridx, rcnt = ck.refine_blocks_plain(*k2_args, rest_filter=rest_filter,
                                        tile_j=tj)
    kidx, kcnt = ck.refine_overlap_blocks_packed(
        n, *k2_args, rest_filter=rest_filter, tile_j=tj)
    k2_case = {"scene": "granular_design_point", "tile_j": tj,
               "rest_filter": rest_filter, "keep_dist": float(keep),
               "equal": bool(torch.equal(kidx, ridx)
                             and torch.equal(kcnt, rcnt)),
               "listed": int(cnt.sum()), "kept": int(rcnt.sum()),
               "max_blocks_per_tile": int(rcnt.max())}
    # the shape table of the frame's last substep (s_pos = pos), packed as
    # the solver packs it, with the frame's shape velocity
    shp, planes2d = _shape_table(sh, sh.pos, sh.quat, s_vel, n_shapes)
    gcase = dict(n=n, rows=rows, cols=cols, idx=ridx, cnt=rcnt, shp=shp,
                 k2_args=k2_args,
                 planes2d=planes2d,
                 scal=(prm.solid_rest_distance, prm.particle_friction,
                       prm.collide_filter_dist),
                 shape_params=(prm.collision_distance,
                               prm.shape_collision_margin,
                               prm.dynamic_friction, prm.dt / g.substeps))
    cases.append({"scene": "granular_design_point",
                  **fused_vs_unfused(gcase, rest_filter, tj)})
    for c in cases:
        k4_err = max(k4_err, c["max_abs_err"])
    # on the shape sets every valid slot meets particles, and an invalid
    # one none
    sets = [c for c in cases if c["scene"] != "granular_design_point"]
    k1_err = max(c["k1_max_abs_err"] for c in cases)
    ok = (all(c["counts_equal"] and c["max_abs_err"] <= K1_ATOL
              and c["k1_counts_equal"] and c["k1_max_abs_err"] <= K1_ATOL
              and c["finite"] and c["shape_contacts"] > 0
              and c["fused_repeats_bitwise"] and c["unfused_repeats_bitwise"]
              for c in cases)
          and all((n > 0) == v for c in sets for n, v in zip(
              c["shape_contacts_by_slot"], c["valid_slots"]))
          and cases[-1]["particle_contacts"] > 0 and k2_case["equal"])
    emit({"phase": "k4_check", "ok": ok, "atol": K1_ATOL, "cases": cases,
          "k2_case": k2_case})
    if not ok:
        raise RuntimeError("K4 check failed")
    out["k4_err"] = k4_err
    out["k1_err"] = k1_err
    out["k2_equal"] = k2_case["equal"]
    k1_contacts = cases[-1]["particle_contacts"]
    out["k4_case"] = gcase

    # the dense band through the same entry point, auto contact mode
    _phase[0] = "granular_dense_path"
    d = dp.granular_dense_point(dev)
    dspec = d.spec
    dn = d.state.particles.pos.shape[0]
    dtj, dqj = dp.board_sweep(d, T_DENSE + 3)
    rollout_steps(d.state, dspec, dtj[:1], dqj[:1], d.substeps, d.iterations,
                  record=False)  # warm-up
    reset_counts()
    (dfinal, drec), dsecs = sync_time(lambda: rollout_steps(
        d.state, dspec, dtj[:T_DENSE], dqj[:T_DENSE], d.substeps,
        d.iterations))
    dcounts = read_counts()
    dfinite = bool(torch.isfinite(drec).all())
    emit({"phase": "granular_dense_path", "n_active": d.n_active,
          "cap": dn, "contact_mode": auto_contact_mode(dn),
          "frames": T_DENSE, "seconds": dsecs,
          "frames_per_s": T_DENSE / dsecs,
          "ms_per_frame": 1e3 * dsecs / T_DENSE, "launches": dcounts,
          "finite": dfinite,
          "max_displacement": float(
              (drec[-1] - d.state.particles.pos).abs().max())})
    if (dcounts["k3"] != d.substeps * d.iterations * T_DENSE
            or dcounts["k1"] != 0 or dcounts["k2"] != 0 or not dfinite):
        raise RuntimeError("granular dense path check failed")
    out["dense_counts"] = dcounts

    # K3 against its plain version: frames of the dense path before and
    # after the pile lands, and the built scene with each granule moved
    # 0.07 x its index back along z so that neighbours overlap
    _phase[0] = "k3_check"
    dp_ = d.state.particles
    dprm = dspec.params
    pressed = dp_.pos.clone()
    pressed[:, 2] -= 0.07 * dp_.group.clamp(min=0).float()
    frames = [("built", dp_.pos, dp_.pos), ("pressed", pressed, dp_.pos)]
    for t in (2, T_DENSE // 2, T_DENSE - 1):
        frames.append((f"frame_{t}", drec[t], drec[t - 1]))
    k3_cases, k3_err, k3_best = [], 0.0, None
    for name, pos, prev in frames:
        rows, cols = ck.pack_contact_tables(
            pos, prev, dp_.group, dp_.inv_mass, dp_.self_collide,
            dp_.active, dspec.rest_pos)
        args = (dn, rows, cols, dprm.solid_rest_distance,
                dprm.particle_friction, dprm.collide_filter_dist)
        kd, kc = ck.dense_contact_deltas_packed(*args)
        pd, pc = ck.dense_contact_plain(*args)
        err = float((kd - pd).abs().max())
        case = {"frame": name, "counts_equal": bool(torch.equal(kc, pc)),
                "max_abs_err": err, "contacts": int(pc.sum()),
                "repeats_bitwise": repeats(
                    lambda args=args: ck.dense_contact_deltas_packed(*args)),
                "finite": bool(torch.isfinite(kd).all())}
        k3_cases.append(case)
        k3_err = max(k3_err, err)
        if k3_best is None or case["contacts"] > k3_best[0]:
            k3_best = (case["contacts"], args)
    ok = (all(c["counts_equal"] and c["max_abs_err"] <= K1_ATOL
              and c["finite"] and c["repeats_bitwise"] for c in k3_cases)
          and any(c["contacts"] > 0 for c in k3_cases))
    emit({"phase": "k3_check", "ok": ok, "atol": K1_ATOL, "cases": k3_cases})
    if not ok:
        raise RuntimeError("K3 check failed")
    out["k3_err"] = k3_err
    out["k3_args"] = k3_best[1]

    # K1 over the dense band's frame with the most contacts, every col block
    # listed for every row tile (rest filter on, tile_j 128), so that every
    # cluster rank of every tile has slots: against K3 and against the
    # plain version on the same tables
    _phase[0] = "k1_full_list"
    fcols = k3_best[1][2]
    nbf = fcols.shape[1] // ck.TILE
    full_idx = torch.arange(nbf, dtype=torch.int32, device=dev).repeat(nbf, 1)
    full_cnt = torch.full((nbf,), nbf, dtype=torch.int32, device=dev)
    fargs = (*k3_best[1], full_idx, full_cnt)
    fd, fc = ck.block_sparse_contact_deltas_packed(*fargs, tile_j=ck.TILE)
    kd3, kc3 = ck.dense_contact_deltas_packed(*k3_best[1])
    pdf, pcf = ck.block_sparse_contact_plain(*fargs, tile_j=ck.TILE)
    geo = build.launch_geometry(lib, "k1", fcols.shape[1], nbf)
    full = {"phase": "k1_full_list", "row_tiles": nbf, "slots": nbf,
            "geometry": geo, "contacts": int(pcf.sum()),
            "counts_equal_k3": bool(torch.equal(fc, kc3)),
            "max_abs_err_k3": float((fd - kd3).abs().max()),
            "counts_equal_plain": bool(torch.equal(fc, pcf)),
            "max_abs_err_plain": float((fd - pdf).abs().max()),
            "repeats_bitwise": repeats(
                lambda: ck.block_sparse_contact_deltas_packed(
                    *fargs, tile_j=ck.TILE))}
    full["ok"] = (full["counts_equal_k3"] and full["counts_equal_plain"]
                  and full["max_abs_err_k3"] <= K1_ATOL
                  and full["max_abs_err_plain"] <= K1_ATOL
                  and full["repeats_bitwise"] and full["contacts"] > 0
                  and nbf >= geo["cluster"])
    emit({**full, "atol": K1_ATOL})
    if not full["ok"]:
        raise RuntimeError("K1 over full lists disagrees")
    out["k1_full_err"] = full["max_abs_err_plain"]

    # card against CPU, GRANULAR_WINDOW frames from the same state, on the
    # dense band and on a block-mode granular scene small enough for the
    # CPU (RandomState
    # 11 in its 4,096 bucket) in the design point's forms: fused shapes,
    # tile_j 256, no rest filter. The free-fall window (from the built
    # scene) is held to FRAME_ATOL. The window with contacts (the pile on
    # the table, the board at it) is held in bulk and tail: a granule's
    # shape matching is over-relaxed 72 times a frame and the velocity
    # update multiplies position rounding by 720, so a 1e-6 nudge of the
    # CPU's own input moves its output by a median of ~1e-5
    # (tests/test_torch_granular.py); the median particle to
    # MEDIAN_X_NUDGED times that nudged median, measured here on
    # the same window, and every particle to CONTACT_MAX_FRAC of the
    # contact distance.
    _phase[0] = "granular_frame_agreement"
    b11 = dp.granular_scene(11, device=dev)
    btj, bqj = dp.board_sweep(b11, T_DENSE + 3)
    scenes = (("dense_band", d, dtj, dqj, {}, dfinal),
              ("block_fused_seed11", b11, btj, bqj,
               dict(contact_mode="block", rest_filter=False,
                    contact_tile_j=DESIGN["tile_j"],
                    n_shapes_active=int(b11.state.shapes.kind.shape[0])),
               None))
    report, failed = {}, []
    for name, sb, ptraj, qtraj, kw, at_window in scenes:
        spec_cpu = tree_to(sb.spec, "cpu")

        def three(state, start, device, sb=sb, ptraj=ptraj, qtraj=qtraj,
                  kw=kw, spec_cpu=spec_cpu):
            sl = slice(start, start + GRANULAR_WINDOW)
            fin, rec = rollout_steps(
                tree_to(state, device),
                sb.spec if device != "cpu" else spec_cpu, ptraj[sl],
                qtraj[sl], sb.substeps, sb.iterations, **kw)
            return rec.cpu(), int(fin.contact_overflow)

        t0 = time.perf_counter()
        card0, og = three(sb.state, 0, dev)
        c0, oc = three(sb.state, 0, "cpu")
        free = float((card0 - c0).abs().max())
        if at_window is None:
            at_window, _ = rollout_steps(sb.state, sb.spec, ptraj[:T_DENSE],
                                         qtraj[:T_DENSE], sb.substeps,
                                         sb.iterations, record=False, **kw)
        card, _ = three(at_window, T_DENSE, dev)
        c, oc2 = three(at_window, T_DENSE, "cpu")
        noise = np.random.RandomState(1).randn(
            *at_window.particles.pos.shape)
        nudged = at_window._replace(particles=at_window.particles._replace(
            pos=at_window.particles.pos + torch.as_tensor(
                noise * 1e-6, dtype=torch.float32, device=dev)))
        cn, _ = three(nudged, T_DENSE, "cpu")
        per_particle = (card - c).abs().amax(dim=(0, 2))
        spread = (cn - c).abs().amax(dim=(0, 2))
        max_diff = float(CONTACT_MAX_FRAC
                         * sb.spec.params.solid_rest_distance)
        sp = sb.spec.params
        act = at_window.particles.active.cpu()
        last = c[-1]
        rows, cols = ck.pack_contact_tables(
            last, last, *(t.cpu() for t in (
                at_window.particles.group, at_window.particles.inv_mass,
                at_window.particles.self_collide, at_window.particles.active,
                sb.spec.rest_pos)))
        _, pc = ck.dense_contact_plain(last.shape[0], rows, cols,
                                       sp.solid_rest_distance.cpu(),
                                       sp.particle_friction.cpu(),
                                       sp.collide_filter_dist.cpu())
        r = report[name] = {
            "n_active": sb.n_active, "mode": kw.get("contact_mode", "auto"),
            f"free_fall_frames_0_{GRANULAR_WINDOW - 1}": {
                "card_vs_cpu_max": free, "overflow": [og, oc],
                "max_displacement": float(
                    (c0[-1] - sb.state.particles.pos.cpu()).abs().max())},
            f"contact_frames_{T_DENSE}_{T_DENSE + GRANULAR_WINDOW - 1}": {
                "card_vs_cpu_max": float(per_particle.max()),
                "card_vs_cpu_median": float(per_particle.median()),
                "cpu_vs_cpu_nudged_1e-6_max": float(spread.max()),
                "cpu_vs_cpu_nudged_1e-6_median": float(spread.median()),
                "particle_contacts_at_end": int(pc.sum()),
                "overflow": oc2,
                "max_displacement": float(
                    (last - at_window.particles.pos.cpu())[act]
                    .abs().max())},
            "seconds": time.perf_counter() - t0}
        if not free <= FRAME_ATOL:
            failed.append(f"{name} free fall")
        median_atol = MEDIAN_X_NUDGED * float(spread.median())
        r[f"contact_frames_{T_DENSE}_{T_DENSE + GRANULAR_WINDOW - 1}"][
            "median_atol"] = median_atol
        if not (float(per_particle.median()) <= median_atol
                and float(per_particle.max()) <= max_diff):
            failed.append(f"{name} contact window")
    emit({"phase": "granular_frame_agreement", "frames": GRANULAR_WINDOW,
          "free_fall_atol": FRAME_ATOL,
          "contact_median_atol": f"{MEDIAN_X_NUDGED} x the nudged "
                                 f"median",
          "contact_max_atol": float(CONTACT_MAX_FRAC * 0.03), **report})
    if failed:
        raise RuntimeError(f"card and CPU granular frames disagree in "
                           f"{failed}")

    # kernel times at the granular shapes (K3, K4; K1 and K2 at the design
    # point's last frame)
    _phase[0] = "kernel_times"
    stream = torch.cuda.current_stream().cuda_stream
    dn_, drows, dcols = k3_best[1][:3]
    dn_pad = dcols.shape[1]
    s3 = ck.device_scalars(dev, *k3_best[1][3:])
    delta3 = torch.empty((dn_, 3), device=dev)
    count3 = torch.empty((dn_,), device=dev)
    k3_ptrs = [t.data_ptr() for t in (drows, dcols, s3, delta3, count3)]

    def k3_raw():
        build.check(lib, lib.ag_dense_contact(*k3_ptrs, dn_, dn_pad, stream),
                    "K3")

    a = gcase
    n_pad = a["cols"].shape[1]
    empty_cnt = torch.zeros_like(a["cnt"])
    s4 = ck.device_scalars(dev, *a["scal"], *a["shape_params"])
    delta4 = torch.empty((n, 3), device=dev)
    count4 = torch.empty((n,), device=dev)
    n_pl = 0 if a["planes2d"] is None else a["planes2d"].shape[0] // n_shapes
    planes_ptr = None if a["planes2d"] is None else a["planes2d"].data_ptr()

    def k4_raw(block_cnt):
        ptrs = [t.data_ptr() for t in (a["rows"], a["cols"], a["idx"],
                                       block_cnt, s4, a["shp"])]
        build.check(lib, lib.ag_block_sparse_contact_shapes(
            *ptrs, planes_ptr, delta4.data_ptr(), count4.data_ptr(), n,
            n_pad, a["idx"].shape[1], tj, int(rest_filter), n_shapes, n_pl,
            stream), "K4")

    s1 = ck.device_scalars(dev, *a["scal"])
    maxb = a["idx"].shape[1]

    def k1_raw(block_cnt):
        ptrs = [t.data_ptr() for t in (a["rows"], a["cols"], a["idx"],
                                       block_cnt, s1, delta4, count4)]
        build.check(lib, lib.ag_block_sparse_contact(
            *ptrs, n, n_pad, maxb, tj, int(rest_filter), stream), "K1")

    def k2_raw(k2_args):
        s2 = ck.device_scalars(dev, k2_args[2], k2_args[3])
        new_idx = torch.empty_like(k2_args[4])
        new_cnt = torch.empty_like(k2_args[5])

        def launch():  # holds the scalars and outputs while it is timed
            ptrs = [t.data_ptr() for t in (*k2_args[:2], *k2_args[4:], s2,
                                           new_idx, new_cnt)]
            build.check(lib, lib.ag_refine_blocks(
                *ptrs, n_pad, k2_args[4].shape[1], tj, int(rest_filter),
                stream), "K2")
        return launch

    # K2 at the design point's last frame, and at its first frame after
    # landing
    k2_args, k2_landed = a["k2_args"], out["k2_landed_args"]
    k2_last, k2_land = k2_raw(k2_args), k2_raw(k2_landed)

    k1_args = (n, a["rows"], a["cols"], *a["scal"], a["idx"], a["cnt"])
    k1_kw = dict(rest_filter=rest_filter, tile_j=tj)

    pos_i, prev_i = a["rows"][:n, 0:3], a["rows"][:n, 3:6]
    unfused = (pos_i, prev_i, sh, sh.pos, sh.quat, s_vel,
               prm.collision_distance, prm.shape_collision_margin,
               prm.dynamic_friction, prm.dt / g.substeps)
    plain4 = (pos_i, prev_i, a["shp"], a["planes2d"], *a["shape_params"])
    times = {
        "k3_plain_a": event_ms(lambda: ck.dense_contact_plain(*k3_best[1]), 5),
        "k3": event_ms(k3_raw, 100),
        "k3_b": event_ms(k3_raw, 100),
        "k3_plain_b": event_ms(lambda: ck.dense_contact_plain(*k3_best[1]), 5),
        "k4_plain_a": event_ms(lambda: ck.shape_stage_plain(*plain4), 10),
        # K4 alone (the fused launch over empty lists) beside the unfused
        # launch over the same empty lists, the floor it stands on
        "k1_empty": event_ms(lambda: k1_raw(empty_cnt), 200),
        "k4_alone": event_ms(lambda: k4_raw(empty_cnt), 200),
        "k4_alone_b": event_ms(lambda: k4_raw(empty_cnt), 200),
        "k1_empty_b": event_ms(lambda: k1_raw(empty_cnt), 200),
        "k4_plain_b": event_ms(lambda: ck.shape_stage_plain(*plain4), 10),
        "unfused_shape_pass_a": event_ms(
            lambda: shape_contact_deltas(*unfused), 20),
        "unfused_shape_pass_b": event_ms(
            lambda: shape_contact_deltas(*unfused), 20),
        "k1_granular_plain_a": event_ms(
            lambda: ck.block_sparse_contact_plain(*k1_args, **k1_kw), 3),
        "k1_granular": event_ms(lambda: k1_raw(a["cnt"]), 100),
        "k1_granular_b": event_ms(lambda: k1_raw(a["cnt"]), 100),
        "k1_granular_plain_b": event_ms(
            lambda: ck.block_sparse_contact_plain(*k1_args, **k1_kw), 3),
        "k1_fused_granular": event_ms(lambda: k4_raw(a["cnt"]), 100),
        "k1_fused_granular_b": event_ms(lambda: k4_raw(a["cnt"]), 100),
        "k2_granular_plain_a": event_ms(
            lambda: ck.refine_blocks_plain(*k2_args, **k1_kw), 3),
        "k2_granular": event_ms(k2_last, 100),
        "k2_granular_b": event_ms(k2_last, 100),
        "k2_granular_plain_b": event_ms(
            lambda: ck.refine_blocks_plain(*k2_args, **k1_kw), 3),
        "k2_landed_plain_a": event_ms(
            lambda: ck.refine_blocks_plain(*k2_landed, **k1_kw), 3),
        "k2_landed": event_ms(k2_land, 100),
        "k2_landed_b": event_ms(k2_land, 100),
        "k2_landed_plain_b": event_ms(
            lambda: ck.refine_blocks_plain(*k2_landed, **k1_kw), 3),
    }
    _, pc3 = ck.dense_contact_plain(*k3_best[1])
    contacts3 = int(pc3.sum())
    # the function's pairs: every pair of the dense band's active particles
    # (the padded rows and columns are inactive and never in contact)
    pairs3 = d.n_active * d.n_active
    k3_bytes = 2 * dn_pad * 16 * 4 + 3 * 4 + dn_ * 4 * 4
    k3_ops = DETECT_OPS * pairs3 + PROJECT_OPS * contacts3
    # K1 and K2 at the design point, counted as at the rope point: K1's
    # detection on every listed pair and projection on each contact; K2's
    # detection on the listed pairs within its keep distance (near_pairs)
    nb = a["idx"].shape[0]
    table_bytes = 2 * n_pad * 16 * 4
    list_bytes = (nb * maxb + nb) * 4
    pairs1 = int(a["cnt"].sum()) * ck.TILE * tj
    k1_bytes = table_bytes + list_bytes + 3 * 4 + n * 4 * 4
    k1_ops = DETECT_OPS * pairs1 + PROJECT_OPS * k1_contacts
    k2_bytes = table_bytes + 2 * list_bytes + 2 * 4
    pairs2 = int(k2_args[5].sum()) * ck.TILE * tj
    pairs2_landed = int(k2_landed[5].sum()) * ck.TILE * tj
    near2 = near_pairs(*k2_args[:3], *k2_args[4:], tj)
    near2_landed = near_pairs(*k2_landed[:3], *k2_landed[4:], tj)
    per_particle_ops = shape_ops(a["shp"], a["planes2d"])
    k4_bytes = n * 6 * 4 + n * 4 * 4 + a["shp"].numel() * 4
    k4_ops = n * per_particle_ops
    out["k1_bound"] = bound(k1_bytes, k1_ops)
    out["k2_bound"] = bound(k2_bytes, DETECT_OPS * near2)
    out["k2_landed_bound"] = bound(k2_bytes, DETECT_OPS * near2_landed)
    out["k3_bound"] = bound(k3_bytes, k3_ops)
    out["k4_bound"] = bound(k4_bytes, k4_ops)
    out["times"] = times
    out["geometry"] = {
        "k1_granular": build.launch_geometry(lib, "k1", n_pad, maxb),
        "k3": build.launch_geometry(lib, "k3", dn_pad),
        "k2_granular": build.launch_geometry(lib, "k2", n_pad,
                                             k2_args[4].shape[1])}
    out["detail"] = {
        "k3": {"n": dn_, "n_active": d.n_active, "n_pad": dn_pad,
               "pairs": pairs3,
               "contacts": contacts3, "bytes": k3_bytes, "ops": k3_ops},
        "k4": {"n": n, "valid_shapes": int((a["shp"][:, 1] > 0.5).sum()),
               "shape_rows": n_shapes, "ops_per_particle": per_particle_ops,
               "bytes": k4_bytes, "ops": k4_ops,
               "timed_as": "fused launch over empty block lists, less the "
                           "unfused launch over the same lists"},
        "k1_granular": {"tile_j": tj, "rest_filter": rest_filter,
                        "listed_blocks": int(a["cnt"].sum()),
                        "pairs": pairs1, "contacts": k1_contacts,
                        "bytes": k1_bytes, "ops": k1_ops},
        "k2_granular": {"listed_blocks": int(k2_args[5].sum()),
                        "max_blocks_per_tile": int(k2_args[5].max()),
                        "listed_pairs": pairs2, "near_pairs": near2,
                        "bytes": k2_bytes, "ops": DETECT_OPS * near2},
        "k2_landed": {"frame": T_LANDED,
                      "listed_blocks": int(k2_landed[5].sum()),
                      "max_blocks_per_tile": int(k2_landed[5].max()),
                      "listed_pairs": pairs2_landed,
                      "near_pairs": near2_landed, "bytes": k2_bytes,
                      "ops": DETECT_OPS * near2_landed}}
    return out


def jittered(state, amp, seed=0):
    """`state` with its particles moved by up to `amp` along x and z."""
    p = state.particles
    noise = np.random.RandomState(seed).uniform(-amp, amp, tuple(p.pos.shape))
    noise[:, 1] = 0.0
    return state._replace(particles=p._replace(pos=p.pos + torch.as_tensor(
        noise, dtype=torch.float32, device=p.pos.device)))


def nudged(state, seed=1):
    """`state` with its positions moved by 1e-6 times a normal draw."""
    p = state.particles
    noise = np.random.RandomState(seed).randn(*p.pos.shape) * 1e-6
    return state._replace(particles=p._replace(pos=p.pos + torch.as_tensor(
        noise, dtype=torch.float32, device=p.pos.device)))


def cloth_phases(dev, lib):
    """The cloth design point on the card: the path through rollout_steps,
    K1 and K2 against their plain versions on its inputs, card frames
    against CPU frames, and K1's and K2's times. Returns what the kernel
    table needs."""
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.solver import (
        auto_contact_mode, auto_tile_j, frame_block_lists, rollout_steps)
    from adaptigraph_torch.engine.state import tree_to
    from adaptigraph_torch.kernels import build
    from adaptigraph_torch.scenes import design_point as dp

    out = {}
    _phase[0] = "cloth_scene"
    t0 = time.perf_counter()
    c = dp.cloth_design_point(dev)
    spec, prm = c.spec, c.spec.params
    cp = c.state.particles
    n = cp.pos.shape[0]
    tj = auto_tile_j(n)
    rest_filter = bool(cp.self_collide[: c.n_active].any())
    sh = c.state.shapes
    idx0, _, ov0, _ = frame_block_lists(cp, spec, (sh.pos - sh.prev_pos)
                                        / prm.dt, tj)
    fam = spec.offset_springs
    info = {"phase": "cloth_scene", "n_active": c.n_active, "cap": n,
            "contact_mode": auto_contact_mode(n), "tile_j": tj,
            "rest_filter": rest_filter, "blocks": list(idx0.shape),
            "offsets": list(fam.offsets),
            "family_springs": int(fam.valid.sum()),
            "springs_left_over": int(spec.springs.idx.shape[0]),
            "substeps": c.substeps, "iterations": c.iterations,
            "seconds": time.perf_counter() - t0}
    ok = (c.n_active == n == CLOTH_DESIGN["n_active"]
          and tuple(fam.offsets) == CLOTH_DESIGN["offsets"]
          and auto_contact_mode(n) == "block" and tj == CLOTH_DESIGN["tile_j"]
          and tuple(idx0.shape) == CLOTH_DESIGN["blocks"] and rest_filter
          and info["springs_left_over"] == 0 and int(ov0) == 0
          and (c.substeps, c.iterations) == (4, 50))
    emit({**info, "ok": ok})
    if not ok:
        raise RuntimeError("the cloth design point is not as expected")

    # the path: rollout_steps, the shapes unfused (SimEnv's default)
    _phase[0] = "cloth_path"
    ptj, qtj = dp.cloth_sweep(c, T_CLOTH + 1)
    rollout_steps(c.state, spec, ptj[:1], qtj[:1], c.substeps, c.iterations,
                  record=False)  # warm-up

    def path():  # in two calls, to keep the state of a landed frame
        landed, _ = rollout_steps(c.state, spec, ptj[:T_CLOTH_LANDED],
                                  qtj[:T_CLOTH_LANDED], c.substeps,
                                  c.iterations, record=False)
        return landed, rollout_steps(
            landed, spec, ptj[T_CLOTH_LANDED:T_CLOTH],
            qtj[T_CLOTH_LANDED:T_CLOTH], c.substeps, c.iterations,
            record=False)[0]

    reset_counts()
    (landed, final), secs = sync_time(path)
    counts = read_counts()
    iters = c.substeps * c.iterations
    fpos = final.particles.pos
    overflow = int(final.contact_overflow)
    finite = bool(torch.isfinite(fpos).all())
    lowest = float(fpos[:, 1].min())
    pushed = int(((fpos - cp.pos)[:, 0] > 0.01).sum())
    emit({"phase": "cloth_path", "frames": T_CLOTH, "seconds": secs,
          "frames_per_s": T_CLOTH / secs, "ms_per_frame": 1e3 * secs / T_CLOTH,
          "launches": counts,
          "launches_per_frame": {k: v / T_CLOTH for k, v in counts.items()},
          "contact_overflow": overflow, "finite": finite,
          "lowest_particle_y": lowest,
          "particles_pushed_0.01_along_x": pushed,
          "max_displacement": float((fpos - cp.pos).abs().max())})
    if (counts["k1"] != iters * T_CLOTH or counts["k2"] != T_CLOTH
            or counts["k3"] != 0 or counts["k4"] != 0
            or counts["unfused_shape_pass"] != iters * T_CLOTH
            or overflow != 0 or not finite or pushed == 0
            or not 0.0 < lowest < 2 * float(prm.collision_distance)):
        raise RuntimeError("cloth path check failed")
    out["counts"] = counts

    # K2 and K1 against their plain versions: a landed frame, the last
    # frame (the box pushing), and the last frame jittered into contact
    _phase[0] = "cloth_kernel_check"
    cases, k1_err, inputs = [], 0.0, {}
    kw = dict(rest_filter=rest_filter, tile_j=tj)
    for name, st in (("landed", landed), ("pushed", final),
                     ("pushed_jittered", jittered(final, CLOTH_JITTER))):
        a = kernel_inputs(st, spec, tj, substeps=c.substeps)
        k2_args = (a["rows"], a["cols"], a["keep"], prm.collide_filter_dist,
                   a["idx"], a["cnt"])
        ki, kc = ck.refine_overlap_blocks_packed(n, *k2_args, **kw)
        pi, pc = ck.refine_blocks_plain(*k2_args, **kw)
        k1_args = (n, a["rows1"], a["cols1"], prm.solid_rest_distance,
                   prm.particle_friction, prm.collide_filter_dist, pi, pc)
        kd, kcnt = ck.block_sparse_contact_deltas_packed(*k1_args, **kw)
        pd, pcnt = ck.block_sparse_contact_plain(*k1_args, **kw)
        err = float((kd - pd).abs().max())
        k1_err = max(k1_err, err)
        cases.append({
            "frame": name, "keep_dist": float(a["keep"]),
            "listed": int(a["cnt"].sum()), "kept": int(pc.sum()),
            "k2_equal": bool(torch.equal(ki, pi) and torch.equal(kc, pc)),
            "k2_repeats_bitwise": repeats(
                lambda: ck.refine_overlap_blocks_packed(n, *k2_args, **kw)),
            "k1_counts_equal": bool(torch.equal(kcnt, pcnt)),
            "k1_max_abs_err": err, "contacts": int(pcnt.sum()),
            "k1_repeats_bitwise": repeats(
                lambda: ck.block_sparse_contact_deltas_packed(*k1_args,
                                                              **kw)),
            "finite": bool(torch.isfinite(kd).all())})
        inputs[name] = (a, k2_args, k1_args)
    ok = (all(x["k2_equal"] and x["k2_repeats_bitwise"]
              and x["k1_counts_equal"] and x["k1_max_abs_err"] <= K1_ATOL
              and x["k1_repeats_bitwise"] and x["finite"] for x in cases)
          and cases[-1]["contacts"] > 0)
    emit({"phase": "cloth_kernel_check", "ok": ok, "atol": K1_ATOL,
          "jitter": CLOTH_JITTER, "cases": cases})
    if not ok:
        raise RuntimeError("K1 or K2 disagrees with its plain version on "
                           "the cloth")
    out["k1_err"] = k1_err

    # card against CPU over one frame (the box pushing the landed sheet),
    # beside the CPU's own spread under a 1e-6 nudge of its input
    _phase[0] = "cloth_frame_agreement"
    t0 = time.perf_counter()
    spec_cpu = tree_to(spec, "cpu")
    sl = slice(T_CLOTH, T_CLOTH + 1)

    def one(state, device):
        return rollout_steps(
            tree_to(state, device), spec if device != "cpu" else spec_cpu,
            ptj[sl], qtj[sl], c.substeps, c.iterations)[1].cpu()

    card, cpu, cpu_n = one(final, dev), one(final, "cpu"), one(
        nudged(final), "cpu")
    spread = (cpu_n - cpu).abs().amax(dim=(0, 2))
    median_atol = MEDIAN_X_NUDGED * float(spread.median())
    max_atol = MAX_X_NUDGED * float(spread.max())

    def reading(frame):
        per_particle = (frame - cpu).abs().amax(dim=(0, 2))
        return {"max": float(per_particle.max()),
                "median": float(per_particle.median())}

    # the gates' power: card frames with one pass left out (the offset
    # springs; every shape slot invalid, so the shape pass adds nothing)
    # must fail both gates
    left_out = {
        "no_springs": rollout_steps(
            final, spec._replace(offset_springs=None), ptj[sl], qtj[sl],
            c.substeps, c.iterations)[1].cpu(),
        "no_shapes": one(final._replace(shapes=final.shapes._replace(
            valid=torch.zeros_like(final.shapes.valid))), dev)}
    left_out = {k: reading(v) for k, v in left_out.items()}
    card_r = reading(card)
    r = {"phase": "cloth_frame_agreement", "frame": T_CLOTH,
         "card_vs_cpu_max": card_r["max"],
         "card_vs_cpu_median": card_r["median"],
         "cpu_vs_cpu_nudged_1e-6_max": float(spread.max()),
         "cpu_vs_cpu_nudged_1e-6_median": float(spread.median()),
         "median_atol": median_atol, "max_atol": max_atol,
         "card_pass_left_out_vs_cpu": left_out,
         "particles_moved_over_1e-6": int(
             ((cpu[-1] - fpos.cpu()).abs().amax(-1) > 1e-6).sum()),
         "max_displacement": float((cpu[-1] - fpos.cpu()).abs().max()),
         "seconds": time.perf_counter() - t0}
    r["ok"] = (card_r["median"] <= median_atol and card_r["max"] <= max_atol
               and all(x["median"] > median_atol and x["max"] > max_atol
                       for x in left_out.values()))
    emit(r)
    if not r["ok"]:
        raise RuntimeError("card and CPU cloth frames disagree, or a frame "
                           "with a pass left out passes the gates")

    # K1's and K2's times at the cloth's last frame (the box pushing)
    _phase[0] = "cloth_kernel_times"
    a, k2_args, k1_args = inputs["pushed"]
    timed = k1_k2_times(dev, lib, a, k1_args, k2_args, tj, rest_filter)
    times = out["times"] = timed["times"]
    out.update({k: timed[k] for k in ("k1_bound", "k2_bound", "geometry")})
    out["detail"] = {k: {"frame": T_CLOTH, **v}
                     for k, v in timed["detail"].items()}
    emit({"phase": "cloth_kernel_times", "ok": True, "times_ms": times,
          **out["detail"]})
    return out


def sim_phases(dev, lib, config=None, seed=SIM_SEED, dyn_config=None,
               after_episode=None):
    """The simulator app on the card: one episode through gen_episode (the
    settle and one push, K2 once and K1 substeps x iterations times a
    frame), read back and preprocessed; K1 and K2 against their plain
    versions on a pushed frame; card frames, the IK track and a rendered
    capture against the CPU's; 3 push frames under torch.profiler; K1's
    and K2's times there. `config` (the
    data-gen config) and `dyn_config` (the preprocess config) default to
    the rope's. after_episode(dyn, root), when given, runs once the
    episode is preprocessed (dyn: the preprocess config pointed at it;
    root: its scratch directory), before the directory is removed; its
    result is returned under "after_episode". Returns what the kernel
    table needs."""
    import shutil
    import tempfile

    from adaptigraph_torch.dynamics.preprocess import preprocess
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.state import tree_to
    from adaptigraph_torch.sim import env as senv
    from adaptigraph_torch.sim import render, robot
    from adaptigraph_torch.sim.data_gen import gen_episode
    from adaptigraph_torch.sim.episode_io import load_data
    from adaptigraph_torch.utils import load_config

    out = {}
    _phase[0] = "sim_path"
    cfg = config or load_config("data_gen/rope")
    cfg["dataset"].update(SIM_CUTS)
    d = cfg["dataset"]
    d["base"] = seed  # the base episode writes the cameras' parameters
    tmp = tempfile.mkdtemp(prefix="sim_path_")
    try:
        env = senv.SimEnv(cfg, device=dev)
        # keep the input states of each chunk's first 3 frames: the kernel
        # checks and the card-vs-CPU windows take frames of this run
        kept, frames = {}, [0]
        step = senv.xpbd_step

        def keeping(st, *args, **kw):
            if frames[0] % senv.CHUNK < 3:
                kept[frames[0]] = st
            frames[0] += 1
            return step(st, *args, **kw)

        senv.xpbd_step = keeping
        pushes = keep_pushes(env)
        reset_counts()
        try:
            env, secs = sync_time(lambda: gen_episode(cfg, seed, True, tmp,
                                                      env=env))
        finally:
            senv.xpbd_step = step
        counts = read_counts()
        out["lone"], out["n_active"] = pushes, env.n_active
        n_frames = frames[0]
        settle = -(-env.settle_steps // senv.CHUNK) * senv.CHUNK
        push, plan, cap = (env.stats[k] for k in ("push", "plan", "capture"))
        ep = env.episode_stats
        iters = env.substeps * env.iterations
        fpos = env.state.particles.pos
        overflow = int(env.state.contact_overflow)
        finite = bool(torch.isfinite(fpos).all())
        epi = os.path.join(tmp, d["obj"], f"{seed:06}")
        e0, e1 = (load_data(os.path.join(epi, f"{i:02}.npz")) for i in (0, 1))
        moved = float(np.abs(e1["positions"][-1] - e0["positions"][0]).max())
        r = {"phase": "sim_path", "cuts": SIM_CUTS, "seed": seed,
             "n_active": env.n_active, "cap": env.caps_ep.n,
             "shape_slots": int(env.state.shapes.kind.shape[0]),
             "cameras": f"4 x {d['screenHeight']} x {d['screenWidth']}",
             "frames_run": n_frames, "settle_frames": settle,
             "push_frames": push["frames"], "launches": counts,
             "launches_per_frame": {k: v / n_frames for k, v in counts.items()},
             "push_frames_per_s": push["frames"] / push["seconds"],
             "push_ms_per_frame": 1e3 * push["seconds"] / push["frames"],
             "ik_seconds": plan["ik_seconds"],
             "ik_share_of_push": plan["ik_seconds"]
             / (plan["ik_seconds"] + push["seconds"]),
             "render_ms_per_frame_4_cameras": 1e3 * cap["seconds"]
             / cap["frames"], "captured_frames": cap["frames"],
             "episode_seconds": ep["seconds"], "seconds": secs,
             "pushes_run": ep["pushes_run"], "action": ep["actions"][0].tolist(),
             "contact_overflow": overflow, "finite": finite,
             "rope_moved": moved}
        emit(r)
        if (counts["k1"] != iters * n_frames or counts["k2"] != n_frames
                or counts["k3"] != 0 or counts["k4"] != 0
                or n_frames != settle + push["frames"]
                or ep["pushes_run"] != 1 or ep["stuck"] or overflow != 0
                or not finite or moved < 0.05):
            raise RuntimeError("sim path check failed")
        out["counts"] = counts

        # the episode as written: its schema, dtypes and shapes, the cameras,
        # and preprocess() over it
        _phase[0] = "sim_episode"
        h, w = int(d["screenHeight"]), int(d["screenWidth"])
        schema = []
        for e in (e0, e1):
            t = e["positions"].shape[0]
            schema.append(
                sorted(e) == ["action", "eef_states", "info", "observations",
                              "positions"]
                and int(e["info"]["n_cams"]) == 4
                and int(e["info"]["timestamp"]) == t
                and e["positions"].shape == (t, env.n_active, 3)
                and e["positions"].dtype == np.float32
                and e["eef_states"].shape == (t, 1, 14)
                and e["eef_states"].dtype == np.float32
                and all(e["observations"]["color"][f"cam_{c}"].shape
                        == (t, h, w, 3)
                        and e["observations"]["color"][f"cam_{c}"].dtype
                        == np.uint8
                        and e["observations"]["depth"][f"cam_{c}"].shape
                        == (t, h, w)
                        and e["observations"]["depth"][f"cam_{c}"].dtype
                        == np.uint16 for c in range(4)))
        cam_dir = os.path.join(tmp, d["obj"], "cameras")
        cams = (np.load(os.path.join(cam_dir, "intrinsic.npy")).shape,
                np.load(os.path.join(cam_dir, "extrinsic.npy")).shape)
        dyn = dyn_config or load_config("dynamics/rope")
        dyn["dataset_config"].update(data_dir=tmp,
                                     prep_data_dir=os.path.join(tmp, "prep"))
        preprocess(dyn)
        prep = os.path.join(tmp, "prep", dyn["dataset_config"]["data_name"])
        pairs = np.loadtxt(os.path.join(prep, "frame_pairs",
                                        f"{seed:06}_01.txt"), ndmin=2)
        r = {"phase": "sim_episode", "frames": [e0["positions"].shape[0],
                                                e1["positions"].shape[0]],
             "schema_ok": schema, "camera_shapes": [list(c) for c in cams],
             "frame_pairs": list(pairs.shape),
             "prep_files": sorted(os.listdir(prep))}
        r["ok"] = (all(schema) and cams == ((4, 4), (4, 4, 4))
                   and pairs.shape[0] >= 1 and np.array_equal(
                       e1["action"], ep["actions"][0]))
        emit(r)
        # the last captured frame's 4 camera views, for the native path
        obs = e1["observations"]
        out["frames"] = [(obs["color"][f"cam_{c}"][-1],
                          obs["depth"][f"cam_{c}"][-1]) for c in range(4)]
        if not r["ok"]:
            raise RuntimeError("the episode as written is not as expected")
        if after_episode is not None:
            out["after_episode"] = after_episode(dyn, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # K2 and K1 against their plain versions on the pushed frame (a chunk's
    # first frame) whose first iteration meets the most particle contacts
    _phase[0] = "sim_kernel_check"
    spec, prm = env.spec, env.spec.params
    tj, rf = 128, env.rest_filter
    contacts = {t: frame_contacts(kept[t], spec) for t in kept
                if t % senv.CHUNK == 0 and t >= settle and t + 2 in kept}
    t_check = max(contacts, key=lambda t: (contacts[t], -t))
    a = kernel_inputs(kept[t_check], spec, tj, substeps=env.substeps)
    kw = dict(rest_filter=rf, tile_j=tj)
    k2_args = (a["rows"], a["cols"], a["keep"], prm.collide_filter_dist,
               a["idx"], a["cnt"])
    ki, kc = ck.refine_overlap_blocks_packed(a["n"], *k2_args, **kw)
    pi, pc = ck.refine_blocks_plain(*k2_args, **kw)
    k1_args = (a["n"], a["rows1"], a["cols1"], prm.solid_rest_distance,
               prm.particle_friction, prm.collide_filter_dist, pi, pc)
    kd, kcnt = ck.block_sparse_contact_deltas_packed(*k1_args, **kw)
    pd, pcnt = ck.block_sparse_contact_plain(*k1_args, **kw)
    k1_err = float((kd - pd).abs().max())
    r = {"phase": "sim_kernel_check", "frame": t_check,
         "contacts_by_chunk": contacts,
         "listed": int(a["cnt"].sum()), "kept": int(pc.sum()),
         "k2_equal": bool(torch.equal(ki, pi) and torch.equal(kc, pc)),
         "k2_repeats_bitwise": repeats(
             lambda: ck.refine_overlap_blocks_packed(a["n"], *k2_args, **kw)),
         "k1_counts_equal": bool(torch.equal(kcnt, pcnt)),
         "k1_max_abs_err": k1_err, "contacts": int(pcnt.sum()),
         "k1_repeats_bitwise": repeats(
             lambda: ck.block_sparse_contact_deltas_packed(*k1_args, **kw)),
         "atol": K1_ATOL}
    r["ok"] = (r["k2_equal"] and r["k2_repeats_bitwise"]
               and r["k1_counts_equal"] and k1_err <= K1_ATOL
               and r["k1_repeats_bitwise"] and r["contacts"] > 0)
    emit(r)
    if not r["ok"]:
        raise RuntimeError("K1 or K2 disagrees with its plain version on the "
                           "pushed SimEnv frame")
    out["k1_err"], out["k2_err"] = k1_err, 0

    # card against CPU: the settle's first 3 frames from the built scene
    # within FRAME_ATOL, and the 3 frames from the checked pushed frame held
    # to MEDIAN_X_NUDGED times the CPU's own spread under a 1e-6 nudge
    _phase[0] = "sim_frame_agreement"
    t0 = time.perf_counter()
    spec_cpu = tree_to(spec, "cpu")

    def three(t0, device, nudge=False):
        st = tree_to(kept[t0], device)
        st = nudged(st) if nudge else st
        recs = []
        for k in range(3):
            if k:
                st = st._replace(shapes=tree_to(kept[t0 + k].shapes, device))
            st = senv.xpbd_step(st, spec if device != "cpu" else spec_cpu,
                                env.substeps, env.iterations, rest_filter=rf,
                                n_shapes_active=env.n_shapes_fused)
            recs.append(st.particles.pos.cpu())
        return torch.stack(recs)

    built = (three(0, dev) - three(0, "cpu")).abs().max()
    cpu = three(t_check, "cpu")
    per_particle = (three(t_check, dev) - cpu).abs().amax(dim=(0, 2))
    spread = (three(t_check, "cpu", nudge=True) - cpu).abs().amax(dim=(0, 2))
    r = {"phase": "sim_frame_agreement", "from_built_scene_max": float(built),
         "atol": FRAME_ATOL, "window_start": t_check,
         "card_vs_cpu_max": float(per_particle.max()),
         "card_vs_cpu_median": float(per_particle.median()),
         "cpu_vs_cpu_nudged_1e-6_max": float(spread.max()),
         "cpu_vs_cpu_nudged_1e-6_median": float(spread.median()),
         "median_atol": MEDIAN_X_NUDGED * float(spread.median()),
         "seconds": time.perf_counter() - t0}
    r["ok"] = (r["from_built_scene_max"] <= FRAME_ATOL
               and r["card_vs_cpu_median"] <= r["median_atol"])
    emit(r)
    if not r["ok"]:
        raise RuntimeError("card and CPU SimEnv frames disagree")

    # where a push frame's time goes: SIM_PROFILE_FRAMES frames of the push
    # loop (its tables packed once, as a group packs them) under
    # torch.profiler
    _phase[0] = "sim_profile"
    from adaptigraph_torch.engine.solver import pack_tables_for
    from adaptigraph_torch.tools import profile_frame

    def push_frames():
        st = kept[t_check]
        tables = pack_tables_for(st.particles, spec)
        for k in range(SIM_PROFILE_FRAMES):
            if k:
                st = st._replace(shapes=kept[t_check + k].shapes)
            st = senv.xpbd_step(st, spec, env.substeps, env.iterations,
                                rest_filter=rf,
                                n_shapes_active=env.n_shapes_fused,
                                packed_tables=tables)

    push_frames()  # warm-up
    prof = profile_frame.profiled(push_frames, SIM_PROFILE_FRAMES)
    emit({"phase": "sim_profile", "frames": SIM_PROFILE_FRAMES,
          "window_start": t_check,
          **{k: prof[k] for k in (
              "wall_ms_per_frame", "device_busy_ms_per_frame",
              "device_idle_share", "kernel_launches_per_frame")},
          "top_kernels": prof["top_kernels"][:6]})

    # the IK track of the episode's push on the card and the CPU (from the
    # rest pose, as the episode's first push started)
    _phase[0] = "sim_ik"
    eef, rot, _, t_push, _ = env.scripted_track(ep["actions"][0])
    rots = np.tile(rot[None], (eef.shape[0], 1, 1))
    q0 = np.zeros(6, np.float32)
    q_card = robot.ik_traj(eef[:SIM_IK_FRAMES], rots[:SIM_IK_FRAMES], q0,
                           env.robot_base, device=dev)
    q_cpu, q_nudged = (robot.ik_traj(
        eef[:SIM_IK_FRAMES], rots[:SIM_IK_FRAMES], q, env.robot_base,
        device="cpu") for q in (q0, q0 + np.float32(1e-7)))
    gap = (q_card.cpu() - q_cpu).abs()
    spread = float((q_nudged - q_cpu).abs().max())
    tip, _ = robot.fk_eef(q_card, env.robot_base)
    r = {"phase": "sim_ik", "frames": eef.shape[0], "t_push": t_push,
         "episode_ik_seconds": plan["ik_seconds"],
         "episode_ik_ms_per_frame": 1e3 * plan["ik_seconds"] / plan["frames"],
         "card_vs_cpu_max": float(gap.max()), "compared_frames": SIM_IK_FRAMES,
         "cpu_vs_cpu_nudged_1e-7_max": spread,
         "atol": max(SIM_IK_ATOL, MEDIAN_X_NUDGED * spread),
         "tracking_error_max": float((tip.cpu() - torch.as_tensor(
             eef[:SIM_IK_FRAMES])).abs().max())}
    r["ok"] = r["card_vs_cpu_max"] <= r["atol"]
    emit(r)
    if not r["ok"]:
        raise RuntimeError("the IK track on the card disagrees with the CPU's")

    # the checked pushed frame rendered by the 4 capture cameras on the card
    # and the CPU
    _phase[0] = "sim_render"
    t0 = time.perf_counter()
    st = kept[t_check]

    def frames(device):
        sh = tree_to(st.shapes, device)
        return render.render_frames_batch(
            st.particles.pos.to(device)[None], env.colors.to(device),
            st.particles.active.to(device)[None], sh, sh.pos[None],
            sh.quat[None], env._cam_pos_t.to(device),
            env._cam_fwd_t.to(device), env._intr_t.to(device),
            width=w, height=h)[0]

    f_card, f_cpu = frames(dev), frames("cpu")
    err = (f_card.cpu() - f_cpu).abs()
    off = (err > SIM_RENDER_ATOL * torch.clamp(f_cpu.abs(), min=1.0)).any(
        -1).numpy()
    err, f_cpu = err.numpy(), f_cpu.numpy()
    sil = np.stack([render.silhouette_pixels(f_cpu[c, ..., 4])
                    for c in range(f_cpu.shape[0])])
    (cc, dc), (cp, dp) = (render.quantize_frames(f)
                          for f in (f_card, torch.as_tensor(f_cpu)))
    r = {"phase": "sim_render", "frame": t_check, "cameras": f_cpu.shape[0],
         "pixels": int(off.size), "tol": SIM_RENDER_ATOL,
         "beyond_tol_off_silhouette": int((off & ~sil).sum()),
         "beyond_tol_on_silhouette": int((off & sil).sum()),
         "silhouette_pixels": int(sil.sum()),
         "color_max_abs_err_off_silhouette": float(
             err[..., :3][~sil].max(initial=0.0)),
         "depth_max_rel_err_off_silhouette": float(
             (err[..., 4] / np.maximum(f_cpu[..., 4], 1.0))[~sil].max(
                 initial=0.0)),
         "pixels_beyond_1e-5_abs": int((err > 1e-5).any(-1).sum()),
         "color_off_by_one": int((np.abs(cc.astype(int) - cp) == 1).sum()),
         "color_off_by_more": int((np.abs(cc.astype(int) - cp) > 1).sum()),
         "depth_off_by_one": int((np.abs(dc.astype(int) - dp) == 1).sum()),
         "depth_off_by_more": int((np.abs(dc.astype(int) - dp) > 1).sum()),
         "shape_hits": int((f_cpu[..., 4] > 0).sum()),
         "seconds": time.perf_counter() - t0}
    r["ok"] = r["beyond_tol_off_silhouette"] == 0
    emit(r)
    if not r["ok"]:
        raise RuntimeError("a frame rendered on the card disagrees with the "
                           "CPU's off the silhouettes")

    # K1's and K2's times at the checked pushed frame
    _phase[0] = "sim_kernel_times"
    timed = k1_k2_times(dev, lib, a, k1_args, k2_args, tj, rf)
    out.update(timed)
    out["detail"] = {k: {"frame": t_check, **v}
                     for k, v in timed["detail"].items()}
    emit({"phase": "sim_kernel_times", "ok": True, "times_ms": timed["times"],
          **out["detail"]})
    return out


def keep_pushes(env):
    """Keep what a lone SimEnv's pushes did: `env.plan_push` and
    `env._push_fn` wrapped to record each push's action and each call's
    chunk-end records over the chunks it ran. Returns {"settled": the
    positions after the settle, "pushes": [(action, records)]}, filled as
    the env runs."""
    kept = {"settled": None, "pushes": []}
    plan_push, push_fn = env.plan_push, env._push_fn
    actions = []

    def planning(action):
        actions.append(np.asarray(action).copy())
        return plan_push(action)

    def pushing(*a, **kw):
        out = push_fn(*a, **kw)
        rec = out[1][:kw.get("n_chunks_active") or len(out[1])].copy()
        if kept["settled"] is None:
            kept["settled"] = rec[-1]
        else:
            kept["pushes"].append((actions[-1], rec))
        return out

    env.plan_push, env._push_fn = planning, pushing
    return kept


def batch_phases(dev, config=None, seeds=BATCH_SEEDS, lone=None):
    """Batched episodes on the card: sim.batch_env.generate_batch over
    `seeds`, one push each. Gates: both episodes written, read back and
    preprocessed; env 0's settle and first push equal to the lone run
    `lone` (what keep_pushes kept of a lone SimEnv's episode of seeds[0]);
    no NaN flag; K1 substeps x iterations and K2
    once an env-frame, K3 and K4 none. Returns what the kernels line
    needs."""
    import shutil
    import tempfile

    from adaptigraph_torch.dynamics.preprocess import preprocess
    from adaptigraph_torch.sim import batch_env
    from adaptigraph_torch.sim.episode_io import load_data
    from adaptigraph_torch.utils import load_config

    _phase[0] = "batch_path"
    cfg = config or load_config("data_gen/rope")
    if config is None:
        cfg["dataset"].update(SIM_CUTS)
    d = cfg["dataset"]
    calls, renders = [], []
    run, render = (batch_env.BatchSimEnv.run_pushes,
                   batch_env.BatchSimEnv.render_all)

    def running(self, actions):
        out = run(self, actions)
        calls.append((actions, out[0], out[2], self.stats))
        return out

    def rendering(self):
        out = render(self)
        renders.append(self.render_seconds)
        return out

    batch_env.BatchSimEnv.run_pushes = running
    batch_env.BatchSimEnv.render_all = rendering
    tmp = tempfile.mkdtemp(prefix="batch_path_")
    try:
        reset_counts()
        try:
            benv, secs = sync_time(lambda: batch_env.generate_batch(
                cfg, list(seeds), tmp, device=dev))
        finally:
            batch_env.BatchSimEnv.run_pushes = run
            batch_env.BatchSimEnv.render_all = render
        counts = read_counts()
        b = len(seeds)
        env0 = benv.envs[0]
        iters = env0.substeps * env0.iterations
        env_frames = sum(st["frames_per_env"] for *_, st in calls) * b
        push_calls = calls[1:]  # the first is the settle
        push_frames = sum(st["frames_per_env"] for *_, st in push_calls) * b
        push_s = sum(st["seconds"] for *_, st in push_calls)
        flags = [bool(f.any()) for _, _, f, _ in calls]
        # env 0 against the lone run: the settle, then the first push
        settled = calls[0][1][0][-1]
        act0, rec0 = calls[1][0][0], calls[1][1][0]
        lone_act, lone_rec = lone["pushes"][0]
        n = min(len(rec0), len(lone_rec))
        repadded = bool(benv.repadded[0])
        same_action = act0 is not None and np.array_equal(act0, lone_act)
        if repadded:
            settle_err = float(np.abs(settled - lone["settled"]).max())
            push_err = float(np.abs(rec0[:n] - lone_rec[:n]).max())
            env0_ok = same_action and max(settle_err, push_err) <= BATCH_ATOL
        else:
            env0_ok = (same_action
                       and np.array_equal(settled, lone["settled"])
                       and np.array_equal(rec0[:n], lone_rec[:n]))
        # the episodes as written, read back and preprocessed
        read = 0
        for seed in seeds:
            epi = os.path.join(tmp, d["obj"], f"{int(seed):06}")
            e0, e1 = (load_data(os.path.join(epi, f"{i:02}.npz"))
                      for i in range(2))
            read += int(e0["positions"].ndim == 3 and e1["positions"].ndim == 3
                        and e1["positions"].shape[1:] == e0["positions"].shape[1:])
        prep_files = []
        if config is None:
            dyn = load_config("dynamics/rope")
            dyn["dataset_config"].update(
                data_dir=tmp, prep_data_dir=os.path.join(tmp, "prep"))
            preprocess(dyn)
            prep_files = sorted(os.listdir(os.path.join(
                tmp, "prep", dyn["dataset_config"]["data_name"],
                "frame_pairs")))
        st = benv.episode_stats
        r = {"phase": "batch_path", "seeds": list(seeds),
             "cuts": {**SIM_CUTS} if config is None else "test config",
             "n_active": [e.n_active for e in benv.envs],
             "repadded": list(benv.repadded),
             "attempts": st["attempts"], "stuck": st["stuck"],
             "actions": st["actions"][:, 0].tolist(),
             "seconds": secs, "calls": len(calls),
             "frames_per_env": [c[3]["frames_per_env"] for c in calls],
             "env_frames": env_frames, "launches": counts,
             "launches_per_env_frame": {k: v / env_frames
                                        for k, v in counts.items()},
             "push_frames_per_s_all_envs": push_frames / push_s,
             "push_frames_per_s_per_env": push_frames / push_s / b,
             "gate_render_ms": [1e3 * x for x in renders],
             "nan_flags": flags, "env0_same_action": bool(same_action),
             "env0_equal_to_lone": bool(env0_ok),
             "env0_compared_chunks": n, "episodes_read": read,
             "frame_pair_files": prep_files}
        r["ok"] = bool(
            env0_ok and read == b and not any(flags)
            and not any(st["stuck"])
            and counts["k1"] == iters * env_frames
            and counts["k2"] == env_frames
            and counts["k3"] == 0 and counts["k4"] == 0
            and (config is not None or len(prep_files) == b))
        emit(r)
        if not r["ok"]:
            raise RuntimeError("the batch path's check failed")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"counts": counts, "env_frames": env_frames,
            "env0_equal": bool(env0_ok), "episodes_read": read,
            "seconds": secs, "push_frames_per_s": r["push_frames_per_s_all_envs"],
            "gate_render_ms": r["gate_render_ms"]}


def _ring_producer(name, specs, frames):
    """A second process's producer: the frames into the named ring."""
    from adaptigraph_torch.planning.real_world.shared_memory import (
        SharedMemoryRingBuffer)

    ring = SharedMemoryRingBuffer(name, specs, capacity=8, create=False)
    for i, (color, depth) in enumerate(frames):
        ring.put({"color": color, "depth": depth, "seq": np.array([i])})
    ring.close(unlink=False)


def _shm_names():
    return sorted(f for f in os.listdir("/dev/shm") if f.startswith("agtorch"))


def native_phases(frames, points):
    """The native host libraries on the card's machine: both built with
    its compiler; FPS's index lists native against numpy on `points`;
    `frames` (4 (uint8 colour, uint16 depth) camera frames) through a ring
    from a second process, equal byte for byte; a RealEnv with its doubles
    started, read, pushed once through FakeXarm and stopped; no shared
    memory left behind."""
    import multiprocessing as mp
    import tempfile

    from adaptigraph_torch.kernels import build
    from adaptigraph_torch.planning.real_world.real_env import RealEnv
    from adaptigraph_torch.planning.real_world.shared_memory import (
        SharedMemoryRingBuffer)
    from adaptigraph_torch.utils.host_fps import fps_rad_idx, fps_with_idx

    _phase[0] = "native_path"
    shm0 = _shm_names()
    # a fresh build of both with the g++ where it runs, into a scratch
    # directory (the libraries the paths load may already be built)
    build_dir = build.BUILD_DIR
    with tempfile.TemporaryDirectory(prefix="native_build_") as scratch:
        build.BUILD_DIR = type(build_dir)(scratch)
        try:
            t0 = time.perf_counter()
            compiled = {name: build.build_host(name) is not None
                        for name in ("fps", "shm_ring")}
            build_s = time.perf_counter() - t0
        finally:
            build.BUILD_DIR = build_dir

    t0 = time.perf_counter()
    _, nat = fps_with_idx(points, NATIVE_FPS_N)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, plain = fps_with_idx(points, NATIVE_FPS_N, native=False)
    plain_s = time.perf_counter() - t0
    _, rad_nat = fps_rad_idx(points, NATIVE_FPS_RADIUS, np.random.RandomState(0))
    _, rad_plain = fps_rad_idx(points, NATIVE_FPS_RADIUS,
                               np.random.RandomState(0), native=False)
    fps_ok = (np.array_equal(nat, plain) and np.array_equal(rad_nat, rad_plain)
              and len(nat) == NATIVE_FPS_N)

    h, w = frames[0][1].shape
    specs = {"color": ((h, w, 3), np.uint8), "depth": ((h, w), np.uint16),
             "seq": ((1,), np.int64)}
    name = f"agtorch_smoke_{os.getpid()}"
    ring = SharedMemoryRingBuffer(name, specs, capacity=8)
    try:
        t0 = time.perf_counter()
        proc = mp.Process(target=_ring_producer, args=(name, specs, frames))
        proc.start()
        proc.join(30)
        got = ring.get_last_k(len(frames))
        ring_s = time.perf_counter() - t0
        ring_ok = (proc.exitcode == 0 and len(got) == len(frames) and all(
            g["color"].tobytes() == c.tobytes()
            and g["depth"].tobytes() == dd.tobytes()
            and int(g["seq"][0]) == i
            for i, (g, (c, dd)) in enumerate(zip(got, frames))))
    finally:
        ring.close()

    t0 = time.perf_counter()
    calib = tempfile.mkdtemp(prefix="native_calib_")
    env = RealEnv(task_config={"sim_real_ratio": 10.0,
                               "clipping_height": -0.06},
                  use_robot=False, use_real_cameras=False,
                  resolution=(h, w), calib_dir=calib)
    env.start(wait_ready=20.0)
    try:
        raw = env.cameras.get_obs(max_skew=NATIVE_MAX_SKEW)
        ts = [f["timestamp"][0] for f in raw.values()]
        colors, depths = env.get_obs()
        pushed = env.step(np.array([-1.0, 0.5, 0.5, 0.5]))
        pose = env.robot.get_pose()
    finally:
        env.stop()
        os.rmdir(calib)
    env_s = time.perf_counter() - t0
    left = [f for f in _shm_names() if f not in shm0]
    r = {"phase": "native_path", "compiled": compiled,
         "build_seconds": build_s, "fps_points": len(points),
         "fps_native_ms": 1e3 * native_s, "fps_plain_ms": 1e3 * plain_s,
         "fps_equal": bool(fps_ok), "fps_radius_points": len(rad_nat),
         "ring_frames": len(frames), "ring_bytes": sum(
             c.nbytes + dd.nbytes for c, dd in frames),
         "ring_equal_bytes": bool(ring_ok), "ring_seconds": ring_s,
         "real_env_cameras": len(raw), "real_env_skew_s": max(ts) - min(ts),
         "real_env_colors": [list(colors.shape), str(colors.dtype)],
         "real_env_depths": [list(depths.shape), str(depths.dtype)],
         "real_env_push": bool(pushed), "fake_xarm_pose_mm": pose.tolist(),
         "real_env_seconds": env_s, "shm_left": left}
    r["ok"] = bool(
        all(compiled.values()) and fps_ok and ring_ok and len(raw) == 4
        and max(ts) - min(ts) <= NATIVE_MAX_SKEW
        and colors.shape == (4, h, w, 3) and colors.dtype == np.uint8
        and depths.shape == (4, h, w) and depths.dtype == np.float32
        and pushed and np.allclose(pose[:2], [50.0, 50.0]) and not left)
    emit(r)
    if not r["ok"]:
        raise RuntimeError("the native path's check failed")
    return r


def split_ms(parts, reps):
    """Device ms of each of `parts`, callables run in order each on the
    previous one's result (the first on None), by CUDA events between
    them: the median over `reps` runs of each."""
    times = [[] for _ in parts]
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(parts) + 1)]
        x = None
        ev[0].record()
        for i, fn in enumerate(parts):
            x = fn(x)
            ev[i + 1].record()
        torch.cuda.synchronize()
        for i, t in enumerate(times):
            t.append(ev[i].elapsed_time(ev[i + 1]))
    return [float(np.median(t)) for t in times]


def train_phases(dev, dyn, root, batch=None):
    """Training on the card (train_path) over the sim path's preprocessed
    episode: `dyn` the dynamics config pointed at it, `root` a scratch
    directory for the run's checkpoints and loss files; batch the
    training batch (the config's 128 when None). Card against CPU on one
    step's loss and gradients and on the prepared batch; train() through
    its chunk path and a resume, and through its host loop (equal bit
    for bit); the step's pace. Launches no contact kernel. Returns the numbers printed before
    the last line and the path's launch counts."""
    import contextlib
    import io

    from adaptigraph_torch.dynamics import train as tt
    from adaptigraph_torch.dynamics.dataset import (DynDataset, draw_prepare,
                                                    make_prepare_fn)
    from adaptigraph_torch.tools.profile_frame import profiled

    _phase[0] = "train_grad"
    t_start = time.perf_counter()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    cfg = dyn.override({
        "dataset_config": {"ratio": {"train": [0, 1], "valid": [0, 1]}},
        "train_config": {"out_dir": os.path.join(root, "log")}})
    tcfg = cfg["train_config"]
    b, k = batch or int(tcfg["batch_size"]), TRAIN_K
    d = DynDataset(cfg["dataset_config"], cfg["material_config"], "train")
    seed, lr = int(tcfg.get("random_seed", 42)), float(tcfg.get("lr", 1e-3))
    prepare = make_prepare_fn(d)

    def fresh(device):
        return tt.init_model(cfg, d, device=device, generator=torch.Generator(
        ).manual_seed(seed))[0]

    def host_raw(idx, device):
        return {n: torch.from_numpy(v).to(device)
                for n, v in d.raw_batch(idx).items()}

    def on(device, tree):
        return {n: v.to(device) for n, v in tree.items()}

    # one step's loss and gradients, card against CPU: the same params,
    # the same batch (prepared on the CPU) and draws
    raw = host_raw(np.random.RandomState(seed).randint(0, len(d),
                                                       TRAIN_GRAD_B), "cpu")
    g_cpu = prepare(raw, draw_prepare(torch.Generator().manual_seed(seed),
                                      raw, d))
    grads = {}
    for device, g in (("cpu", g_cpu), (dev, on(dev, g_cpu))):
        model = fresh(device)
        grads[str(device)] = tt.loss_and_grads(
            tt.make_unrolled_loss(model, d.n_future),
            dict(model.named_parameters()), g)
    (lc, gc), (lg, gg) = grads["cpu"], grads[str(dev)]
    leaf_err = {n: float((gg[n].cpu() - v).abs().max()
                         / v.abs().max().clamp(min=1e-30))
                for n, v in gc.items()}
    loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
    r = {"phase": "train_grad", "batch": TRAIN_GRAD_B, "nf": model.cfg.nf,
         "pstep": model.cfg.pstep, "aggregation": model.cfg.aggregation,
         "max_nobj": d.max_nobj, "max_nR": d.max_nR, "n_his": d.n_his,
         "n_future": d.n_future, "augment": d.augment,
         "pairs": len(d), "raw_particles": d.n_raw,
         "ratio": "train and valid [0, 1]: one episode",
         "loss_cpu": float(lc), "loss_card": float(lg),
         "loss_rel_err": loss_err, "grad_leaves": len(gc),
         "grad_rel_err_max": max(leaf_err.values()),
         "grad_rel_err_worst_leaf": max(leaf_err, key=leaf_err.get),
         "rtol": TRAIN_GRAD_RTOL,
         "nodes_per_graph": g_cpu["obj_mask"].sum(1).tolist(),
         "edges_per_graph": g_cpu["edge_valid"].sum(1).tolist()}
    r["ok"] = (loss_err <= TRAIN_GRAD_RTOL
               and r["grad_rel_err_max"] <= TRAIN_GRAD_RTOL
               and bool(np.isfinite(r["loss_card"])))
    emit(r)
    if not r["ok"]:
        raise RuntimeError("one training step's loss or gradients on the "
                           "card disagree with the CPU's")

    # the prepared batch at the training batch, card against CPU from the
    # same raw windows and draws: equal sample by sample
    _phase[0] = "train_prepare"
    raw = host_raw(np.random.RandomState(seed + 1).randint(0, len(d), b),
                   "cpu")
    draws = draw_prepare(torch.Generator().manual_seed(seed), raw, d)
    p_cpu = prepare(raw, draws)
    p_card = prepare(on(dev, raw), on(dev, draws))
    differ = torch.zeros(b, dtype=torch.bool)
    keys_differ = []
    for n, v in p_cpu.items():
        ne = (p_card[n].cpu() != v).reshape(b, -1).any(1)
        differ |= ne
        if bool(ne.any()):
            keys_differ.append(n)
    r = {"phase": "train_prepare", "batch": b,
         "differing_samples": int(differ.sum()), "keys_differing": keys_differ,
         "on_card": all(v.device.type == torch.device(dev).type
                        for v in p_card.values())}
    r["ok"] = r["differing_samples"] == 0 and r["on_card"]
    emit(r)
    if not r["ok"]:
        raise RuntimeError("the batch prepared on the card differs from the "
                           "CPU's")

    # train() on the card through its chunk path: two epochs of one K-step
    # train chunk and one K-step valid chunk, then resumed to a third
    _phase[0] = "train_path"
    logs = []

    def run_train(out, steps_per_call=k, **kw):
        c = cfg.override({"train_config": {"out_dir": os.path.join(root,
                                                                   out)}})
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = tt.train(c, iters=k, batch_size=b, device=dev,
                              steps_per_call=steps_per_call, **kw)
        logs.append(buf.getvalue().splitlines())
        return result

    (params, hist), secs = sync_time(lambda: run_train("log", epochs=2))
    latest = tt.load_checkpoint(os.path.join(
        root, "log", cfg["dataset_config"]["data_name"], "checkpoints"),
        "latest", dev)
    _, hist3 = run_train("log", epochs=3, resume=True)
    train_losses = hist["train"]
    r = {"phase": "train_path", "batch": b, "steps_per_chunk": k,
         "epochs": 2, "train_loss_by_epoch": train_losses,
         "valid_loss_by_epoch": hist["valid"], "seconds": secs,
         "latest_reads_back_equal": all(torch.equal(latest[n], params[n])
                                        for n in params),
         "resumed_train_loss_by_epoch": hist3["train"],
         "resume_log": [ln for ln in logs[1] if "resumed" in ln],
         "log": logs[0][:4]}
    r["ok"] = bool(np.isfinite(train_losses).all()
                   and np.isfinite(hist["valid"]).all()
                   and len(train_losses) == 2
                   and train_losses[1] < train_losses[0]
                   and r["latest_reads_back_equal"]
                   and r["resume_log"] == ["resumed from epoch 2"]
                   and len(hist3["train"]) == 3
                   and hist3["train"][:2] == train_losses)
    emit(r)
    if not r["ok"]:
        raise RuntimeError("train() on the card failed its checks")

    # the same two epochs through train()'s host loop (raw_batch on the
    # host a step): the same batch indices and generator draws, so the
    # same losses and params bit for bit
    _phase[0] = "train_chunk_vs_host"
    host_params, host_hist = run_train("log_host", epochs=2,
                                       steps_per_call=None)
    r = {"phase": "train_chunk_vs_host", "epochs": 2, "steps": 2 * k,
         "batch": b, "losses_equal": host_hist == hist,
         "params_equal": all(torch.equal(params[n], host_params[n])
                             for n in params),
         "params_max_abs_diff": max(float((params[n] - host_params[n])
                                          .abs().max()) for n in params)}
    r["ok"] = r["losses_equal"] and r["params_equal"]
    emit(r)
    if not r["ok"]:
        raise RuntimeError("train()'s chunk path and host loop disagree")

    # the step's pace at the training batch: whole chunks on the host
    # clock, one step split by CUDA events, one step under torch.profiler
    _phase[0] = "train_times"
    common, pairs = tt.device_dataset({"train": d}, device=dev)
    model = fresh(dev)
    opt, _ = tt.make_optimizer(model.parameters(), lr)
    gen = torch.Generator(device=dev).manual_seed(seed)
    chunk, _ = tt.make_train_chunk(model, d.n_future, opt, d, common,
                                   pairs["train"], gen)
    rng = np.random.RandomState(seed + 3)
    tables = [rng.randint(0, len(d), (k, b))
              for _ in range(TRAIN_TIME_CHUNKS)]
    chunk_s = [sync_time(lambda: chunk(t))[1] for t in tables]
    med = float(np.median(chunk_s))
    loss_fn = tt.make_unrolled_loss(model, d.n_future)
    params = dict(model.named_parameters())
    row = torch.as_tensor(tables[0][0]).to(dev)

    def prep_part(_):
        raw = tt._gather_raw(common, pairs["train"], row)
        return prepare(raw, draw_prepare(gen, raw, d))

    def fwd_bwd_part(g):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, g)
        loss.backward()
        return loss

    prep_ms, fb_ms, adam_ms = split_ms(
        [prep_part, fwd_bwd_part, lambda _: opt.step()], TRAIN_SPLIT_STEPS)
    prof = profiled(lambda: chunk(tables[0][:1]), 1)
    prof.pop("profile")
    counts = read_counts()
    resident = sum(v.numel() * v.element_size() for v in
                   list(common.values()) + list(pairs.values()))
    peak = torch.cuda.max_memory_allocated()
    r = {"phase": "train_times", "batch": b, "steps_per_chunk": k,
         "chunks_timed": len(chunk_s), "chunk_seconds": chunk_s,
         "train_steps_per_s": k / med, "train_samples_per_s": k * b / med,
         "ms_per_step": 1e3 * med / k,
         "step_split_ms": {"prepare": prep_ms, "forward_backward": fb_ms,
                           "adam": adam_ms},
         "launches_per_step": prof["kernel_launches_per_frame"],
         "device_busy_ms_per_step": prof["device_busy_ms_per_frame"],
         "device_idle_share": prof["device_idle_share"],
         "profiled_wall_ms_per_step": prof["wall_ms_per_frame"],
         "top_kernels": prof["top_kernels"][:6],
         "resident_bytes": resident, "peak_memory_bytes": peak,
         "contact_launches": counts,
         "seconds": time.perf_counter() - t_start}
    r["ok"] = not any(counts.values())
    emit(r)
    if not r["ok"]:
        raise RuntimeError("a contact kernel launched inside the train path")
    return {"counts": counts, **{n: r[n] for n in (
        "train_steps_per_s", "train_samples_per_s", "ms_per_step",
        "step_split_ms", "launches_per_step", "device_busy_ms_per_step",
        "device_idle_share", "resident_bytes", "peak_memory_bytes")},
        "train_loss_by_epoch": train_losses, "seconds": r["seconds"]}


def toy_graph_batch(dev, b=8, n_obj=100, n_eef=1, n_his=4, max_nr=1000,
                    seed=0):
    """The port's counterpart of __graft_entry__._toy_graph_batch: b
    rope-sized graphs on `dev` (positions 0.3 times a normal draw from a
    numpy seed, the tool row's action 0.1 times one), their edges from the
    port's build_edges_batch (radius 0.5, topk 10, max_nr edges), and the
    same states' slot-layout edges (for the slotted modes) beside them."""
    from adaptigraph_torch.ops import (build_edges_batch,
                                       build_edges_slotted_batch)

    rng = np.random.RandomState(seed)
    n = n_obj + n_eef

    def on(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    state = on((rng.randn(b, n_his, n, 3) * 0.3).astype(np.float32))
    attrs = np.zeros((b, n, 2), np.float32)
    attrs[:, :n_obj, 0] = 1.0
    attrs[:, n_obj:, 1] = 1.0
    eef_mask = np.zeros((b, n), bool)
    eef_mask[:, n_obj:] = True
    action = np.zeros((b, n, 3), np.float32)
    action[:, n_obj:] = rng.randn(b, n_eef, 3) * 0.1
    g = {"state": state, "attrs": on(attrs), "state_mask": on(
        np.ones((b, n), bool), torch.bool), "eef_mask": on(eef_mask, torch.bool),
         "action": on(action), "p_instance": on(np.ones((b, n_obj, 1))),
         "physics_param": on(np.full((b, 1), 0.5)),
         "obj_mask": on(np.ones((b, n_obj), bool), torch.bool)}
    e = build_edges_batch(state[:, -1], 0.5, g["state_mask"], g["eef_mask"],
                          topk=10, max_edges=max_nr)
    s = build_edges_slotted_batch(state[:, -1], 0.5, g["state_mask"],
                                  g["eef_mask"], topk=10, tool_slots=n_eef)
    row = dict(g, recv=e.receivers, send=e.senders, edge_valid=e.valid)
    slot = dict(g, recv=s.receivers, send=s.senders, edge_valid=s.valid)
    return row, slot


def gnn_forward(model, g):
    with torch.no_grad():
        return model(g["state"], g["attrs"], g["recv"], g["send"],
                     g["edge_valid"], g["p_instance"], g["physics_param"],
                     action=g["action"], obj_mask=g["obj_mask"])


def gnn_model(cfg, device, state_dict=None, **over):
    """A DynamicsPredictor of `cfg` (fields replaced by `over`) on `device`,
    its weights from GNN_SEED, or `state_dict` when given."""
    import dataclasses

    from adaptigraph_torch.dynamics import DynamicsPredictor

    model = DynamicsPredictor(dataclasses.replace(cfg, **over), device=device,
                              generator=torch.Generator().manual_seed(
                                  GNN_SEED))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.eval()


def gnn_phases(dev, obj_track, eef_track):
    """The learned step on the card at the rope config's full width (nf
    150, pstep 3, 100 objects and one tool point, max_nR 1000; weights from
    a seed): the entry's B 8 batch in every aggregation mode and in
    bfloat16, then a rollout of the evaluator over the rope main path's
    own push (obj_track (T, N, 3): the rope's recorded positions;
    eef_track (T, 1, 3): the box's centre), card against CPU. Launches no
    contact kernel. Returns the numbers printed before the last line."""
    from adaptigraph_torch.dynamics.model import model_config_from_yaml
    from adaptigraph_torch.dynamics.preprocess import extract_push
    from adaptigraph_torch.dynamics.rollout import (construct_graph,
                                                    make_rollout_step,
                                                    rollout_push)
    from adaptigraph_torch.tools.profile_frame import profiled
    from adaptigraph_torch.utils import load_config

    _phase[0] = "gnn_entry_batch"
    t0 = time.perf_counter()
    reset_counts()
    config = load_config("dynamics/rope")
    dcfg = config["dataset_config"]
    mc = model_config_from_yaml(config["model_config"], dcfg, 1)
    base = dict(aggregation="matmul", compute_dtype=torch.float32)
    card = gnn_model(mc, dev, **base)
    sd = {k: v.detach().cpu() for k, v in card.state_dict().items()}
    row, slot = toy_graph_batch(dev)
    row_cpu, _ = toy_graph_batch("cpu")
    edges_equal = all(torch.equal(row[k].cpu(), row_cpu[k])
                      for k in ("recv", "send", "edge_valid"))
    outs = {"matmul": gnn_forward(card, row),
            "matmul_slotted_edges": gnn_forward(card, slot)}
    models = {"matmul": card}
    for mode in ("segment", "slotted", "slotmm"):
        models[mode] = gnn_model(mc, dev, sd, **dict(base, aggregation=mode))
        outs[mode] = gnn_forward(models[mode], slot if mode != "segment"
                                 else row)
    models["matmul_bf16"] = gnn_model(mc, dev, sd, aggregation="matmul",
                                      compute_dtype=torch.bfloat16)
    outs["matmul_bf16"] = gnn_forward(models["matmul_bf16"], row)
    cpu32 = gnn_forward(gnn_model(mc, "cpu", sd, **base), row_cpu)
    cpu64 = gnn_forward(gnn_model(mc, "cpu", sd, aggregation="matmul",
                                  compute_dtype=torch.float64), row_cpu)
    cpu16 = gnn_forward(gnn_model(mc, "cpu", sd, aggregation="matmul",
                                  compute_dtype=torch.bfloat16), row_cpu)
    scale = float(outs["matmul"][1].abs().max())

    def diff(x, y, i=0):  # i = 0: predicted positions; 1: motions
        return float((x[i].cpu() - y[i].cpu()).abs().max())

    modes = {m: diff(outs[m], outs["matmul_slotted_edges" if m in (
        "slotted", "slotmm") else "matmul"])
        for m in ("segment", "slotted", "slotmm")}
    cpu_rounding = diff(cpu32, cpu64)
    cpu_atol = max(GNN_CPU_ATOL, 3.0 * cpu_rounding)
    r = {"phase": "gnn_entry_batch", "batch": 8, "nodes": 101,
         "edges": int(row["recv"].shape[1]),
         "valid_edges_per_graph": row["edge_valid"].sum(1).tolist(),
         "slot_edges": int(slot["recv"].shape[1]), "nf": mc.nf,
         "pstep": mc.pstep, "edges_card_equal_cpu": edges_equal,
         "mode_vs_matmul_max": modes, "mode_atol": GNN_MODE_ATOL,
         "card_vs_cpu_max": diff(outs["matmul"], cpu32),
         "cpu_f32_vs_f64_max": cpu_rounding,
         "card_vs_cpu_f64_max": diff(outs["matmul"], cpu64),
         "card_vs_cpu_atol": cpu_atol, "motion_scale": scale,
         "bf16_vs_f32_over_scale": diff(outs["matmul_bf16"],
                                        outs["matmul"], 1) / scale,
         "bf16_card_vs_cpu_over_scale": diff(outs["matmul_bf16"], cpu16, 1)
         / scale, "bf16_bound": GNN_BF16_BOUND,
         "finite": all(bool(torch.isfinite(t).all())
                       for o in outs.values() for t in o),
         "on_card": all(t.device.type == torch.device(dev).type
                        for t in list(row.values()) + list(slot.values())
                        + [t for o in outs.values() for t in o]
                        + [p for m in models.values()
                           for p in m.parameters()])}
    times = {}
    for m, model in models.items():
        g = slot if m in ("slotted", "slotmm") else row
        times[m] = event_ms(lambda: gnn_forward(model, g), 20)
    r["forward_b8_ms"] = times
    r["seconds"] = time.perf_counter() - t0
    r["ok"] = (edges_equal and r["finite"] and r["on_card"]
               and max(modes.values()) <= GNN_MODE_ATOL
               and r["card_vs_cpu_max"] <= cpu_atol
               and r["bf16_vs_f32_over_scale"] < GNN_BF16_BOUND
               and r["bf16_card_vs_cpu_over_scale"] < GNN_BF16_BOUND
               and tuple(outs["matmul"][0].shape) == (8, 100, 3))
    emit(r)
    if not r["ok"]:
        raise RuntimeError("the entry batch's forward check failed")

    # the evaluator over the rope main path's push: the frame pairs from
    # the box's track, the start graph (RandomState(42), as rollout.py
    # draws it), then rollout_push on the card and on the CPU, every step's
    # edges recorded; a third run on the CPU from a start state nudged by
    # GNN_NUDGE gives the CPU's own spread
    _phase[0] = "gnn_rollout"
    t0 = time.perf_counter()
    n_his = int(dcfg["n_his"])
    pairs, _ = extract_push(eef_track, float(dcfg["dist_thresh"]), n_his,
                            int(dcfg["n_future"]), 0)
    pair = pairs[0]
    phys = np.array([0.5], np.float32)
    max_nobj = int(dcfg["datasets"][0]["max_nobj"])
    cpu = gnn_model(mc, "cpu", sd, **base)

    def start(device, nudge=0.0):
        g, idx = construct_graph(dcfg, eef_track, obj_track, n_his, pair,
                                 phys, np.random.RandomState(42),
                                 device=device)
        if nudge:
            noise = np.random.RandomState(1).randn(*g["state"].shape)
            g["state"] = g["state"] + torch.as_tensor(
                noise * nudge, dtype=torch.float32, device=device)
        return g, idx

    def roll(model, g, idx, seen=None):
        """rollout_push from graph g; with `seen`, every step's edges,
        whether its tensors are on g's device, and whether its prediction
        is finite are recorded into it."""
        step = make_rollout_step(model, dcfg)
        device = g["state"].device

        def recorded(params, graph, a, b_):
            pred, graph = step(params, graph, a, b_)
            seen["edges"].append(tuple(graph[k].cpu() for k in (
                "recv", "send", "edge_valid")))
            seen["on_device"].append(all(
                v.device == device for v in list(graph.values())
                + [pred, a, b_]))
            seen["finite"].append(bool(torch.isfinite(pred).all()))
            return pred, graph

        return rollout_push(dict(model.state_dict()),
                            recorded if seen is not None else step, g, idx,
                            pairs, eef_track, obj_track, n_his,
                            pair[n_his - 1], pair[n_his], max_nobj,
                            GNN_STEPS, scan=True)

    runs = {}
    for name, model, device, nudge in (("card", card, dev, 0.0),
                                       ("cpu", cpu, "cpu", 0.0),
                                       ("nudged", cpu, "cpu", GNN_NUDGE)):
        g, idx = start(device, nudge)
        seen = {"edges": [], "on_device": [], "finite": []}
        runs[name] = (roll(model, g, idx, seen), seen, g, idx)
    (e_card, s_card, g_card, idx), (e_cpu, s_cpu, _, idx_cpu) = (
        runs["card"], runs["cpu"])
    e_nudged, s_nudged = runs["nudged"][:2]
    steps = len(e_card)

    def same(x, y):
        return all(torch.equal(u, v) for u, v in zip(x, y))

    edges_equal = [same(x, y) for x, y in zip(s_card["edges"],
                                              s_cpu["edges"])]
    kept = 0  # the steps before the nudged CPU run first changes its edges
    while kept < steps and same(s_nudged["edges"][kept], s_cpu["edges"][kept]):
        kept += 1
    d_card = np.abs(np.array(e_card) - np.array(e_cpu))
    d_nudged = np.abs(np.array(e_nudged) - np.array(e_cpu))
    spread = float(d_nudged[:kept].max()) if kept else 0.0
    strict = bool(len(e_cpu) == steps and d_card.max() <= GNN_ERR_ATOL
                  and all(edges_equal))
    nudged_gate = bool(kept >= 3 and spread > GNN_ERR_ATOL
                       and d_card[:kept].max() <= MEDIAN_X_NUDGED * spread
                       and all(edges_equal[:kept]))
    r = {"phase": "gnn_rollout", "frames": int(obj_track.shape[0]),
         "particles": int(obj_track.shape[1]), "nodes": int(len(idx)),
         "start_pair": pair.tolist(), "steps": steps,
         "valid_edges_by_step": [int(e[2].sum()) for e in s_card["edges"]],
         "errors_card": e_card, "card_vs_cpu_error_max": float(d_card.max()),
         "card_vs_cpu_error_by_step": d_card.tolist(),
         "edges_equal_by_step": edges_equal, "error_atol": GNN_ERR_ATOL,
         "cpu_nudged_1e-6_error_by_step": d_nudged.tolist(),
         "cpu_nudged_keeps_edges_steps": kept,
         "cpu_nudged_spread": spread,
         "nudged_gate": MEDIAN_X_NUDGED * spread,
         "held_by": "1e-5" if strict else "nudged" if nudged_gate else None,
         "same_fps_idx": bool(np.array_equal(idx, idx_cpu)),
         "on_card": all(s_card["on_device"]) and all(
             t.device.type == torch.device(dev).type
             for t in g_card.values()),
         "finite": all(s_card["finite"]) and all(s_cpu["finite"])}

    # the step's pace: the evaluator's loop on the card, host clock synced
    # (pred goes to the host every step), then the same loop profiled
    roll(card, g_card, idx)  # warm-up
    _, secs = sync_time(lambda: roll(card, g_card, idx))
    prof = profiled(lambda: roll(card, g_card, idx), steps)
    prof.pop("profile")
    counts = read_counts()
    r.update(graph_steps_per_s=steps / secs, ms_per_step=1e3 * secs / steps,
             launches_per_step=prof["kernel_launches_per_frame"],
             device_idle_share=prof["device_idle_share"],
             device_busy_ms_per_step=prof["device_busy_ms_per_frame"],
             profiled_wall_ms_per_step=prof["wall_ms_per_frame"],
             top_kernels=prof["top_kernels"][:6], contact_launches=counts,
             seconds=time.perf_counter() - t0)
    r["ok"] = bool((strict or nudged_gate) and r["on_card"] and r["finite"]
                   and r["same_fps_idx"]
                   and steps >= 10 and not any(counts.values()))
    emit(r)
    if not r["ok"]:
        raise RuntimeError("the learned step's rollout check failed")
    return {"graph_steps_per_s": r["graph_steps_per_s"],
            "ms_per_step": r["ms_per_step"],
            "forward_b8_ms": times["matmul"],
            "forward_b8_ms_by_mode": times,
            "launches_per_step": r["launches_per_step"],
            "device_idle_share": r["device_idle_share"],
            "device_busy_ms_per_step": r["device_busy_ms_per_step"]}


def card_against_cpu(card_states, card_parts, cpu_run):
    """A planning population's predicted states and reward parts on the
    card against the CPU's: cpu_run(nudge) gives (states, parts) on the
    CPU from the same inputs, the state nudged by `nudge` times a normal
    draw. Each is held within PLAN_ATOL, or MEDIAN_X_NUDGED times the CPU's
    own spread under a GNN_NUDGE nudge where that is larger."""
    with torch.no_grad():
        runs = {name: cpu_run(nudge)
                for name, nudge in (("cpu", 0.0), ("nudged", GNN_NUDGE))}

    def gap(x, y):
        return float((x.cpu() - y.cpu()).abs().max())

    keys = ("error", "collision", "box_pen")
    out = {"state_max": gap(card_states, runs["cpu"][0]),
           "state_spread": gap(runs["nudged"][0], runs["cpu"][0]),
           "parts_max": {k: gap(card_parts[k], runs["cpu"][1][k])
                         for k in keys},
           "parts_spread": {k: gap(runs["nudged"][1][k], runs["cpu"][1][k])
                            for k in keys}}
    out["state_atol"] = max(PLAN_ATOL, MEDIAN_X_NUDGED * out["state_spread"])
    out["parts_atol"] = max(PLAN_ATOL, MEDIAN_X_NUDGED
                            * max(out["parts_spread"].values()))
    out["ok"] = (out["state_max"] <= out["state_atol"]
                 and max(out["parts_max"].values()) <= out["parts_atol"])
    return out


def plan_phases(dev, frame, target_frame, n_sample=PLAN_SAMPLES,
                max_nobj=None, n_chunk=None):
    """MPPI on the learned step at the rope task's full width (200 objects
    + the pusher, topk 10, n_his 4, repeats 5-15, n_look_ahead 1; nf 150,
    pstep 3, matmul, float32; weights from GNN_SEED; physics param 0.5),
    composed as plan.py composes it: the current state from `frame` (the
    rope main path's last recorded frame), the target from `target_frame`,
    n_sample pushes in the config's chunks, PLAN_ITERS iterations from the
    initial action [-1, 0, 0, action_lower_lim[3]]. Gates: card against
    CPU on PLAN_CPU_SAMPLES samples, chunking a memory layout only, sample
    0 of iteration 1 the incumbent, every action in the box, no contact
    kernel, finite rewards and states. Then the chunk forward's time in
    each aggregation mode, the chunk's edge rebuild, a chunk's rollout
    under the profiler. Returns the numbers printed before the last line.
    (max_nobj and n_chunk replace the config's for a rehearsal on the
    CPU.)"""
    import dataclasses

    from adaptigraph_torch.dynamics.model import model_config_from_yaml
    from adaptigraph_torch.ops import build_edges_slotted_batch
    from adaptigraph_torch.planning import Planner
    from adaptigraph_torch.planning.actions import optimize_action_mppi
    from adaptigraph_torch.planning.costs import running_cost_parts
    from adaptigraph_torch.planning.forward_dynamics import (
        make_batched_dynamics)
    from adaptigraph_torch.tools.profile_frame import profiled
    from adaptigraph_torch.tools.profile_plan import (forward_ops,
                                                      initial_action,
                                                      plan_evaluator,
                                                      plan_points, plan_state,
                                                      plan_target, plan_task,
                                                      planner_config)
    from adaptigraph_torch.utils import load_config

    _phase[0] = "plan_mppi"
    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    reset_counts()
    config = load_config("dynamics/rope")
    mc = model_config_from_yaml(config["model_config"],
                                config["dataset_config"], 1)
    base = dict(aggregation="matmul", compute_dtype=torch.float32)
    card = gnn_model(mc, dev, **base)
    sd = {k: v.detach().cpu() for k, v in card.state_dict().items()}
    cpu = gnn_model(mc, "cpu", sd, **base)
    params, cpu_params = dict(card.state_dict()), dict(cpu.state_dict())
    tc = plan_task(max_nobj, n_chunk)
    n_max = int(tc["max_nobj"])
    chunk = int(tc.get("n_sample_chunk", 0) or 0)
    pts = plan_points(frame, tc)
    target = plan_target(target_frame, tc)

    def inputs(device, nudge=0.0):
        p = pts + (np.random.RandomState(1).randn(*pts.shape) * nudge
                   ).astype(np.float32) if nudge else pts
        return plan_state(p, tc, device) + (
            torch.tensor([0.5], device=device),)

    st, mk, phys = inputs(dev)
    rollout = make_batched_dynamics(card, tc)
    evaluate, err, pen, bbox = plan_evaluator(tc, st, mk, target)
    seen = {"acts": [], "states": [], "rewards": [], "graph": None}

    def capture(module, args, kwargs, out):  # the first chunk's first graph
        if seen["graph"] is None:
            seen["graph"] = (args, kwargs)

    def model_rollout(sc, act_seqs):
        hook = card.register_forward_hook(capture, with_kwargs=True)
        try:
            out = rollout(params, st, mk, act_seqs, phys)
        finally:
            hook.remove()
        if act_seqs.shape[0] == n_sample:
            seen["acts"].append(act_seqs)
            seen["states"].append(out["state_seqs"])
        return out

    def evaluate_seen(state_seqs, act_seqs, state_cur=None, **kw):
        ev = evaluate(state_seqs, act_seqs)
        if act_seqs.shape[0] == n_sample:
            seen["rewards"].append(ev["reward_seqs"])
        return ev

    planner = Planner(planner_config(tc, n_sample, model_rollout,
                                     evaluate_seen, dev, PLAN_ITERS))
    init_act = initial_action(tc)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    res, secs = sync_time(lambda: planner.trajectory_optimization(
        st, init_act, seed=PLAN_SEED))
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    counts = read_counts()
    acts0, acts1 = seen["acts"]
    r0, r1 = seen["rewards"]
    states0 = seen["states"][0]
    lower, upper = planner.lower, planner.upper
    incumbent = optimize_action_mppi(acts0, r0, planner.reward_weight, lower,
                                     upper, planner.push_length)
    best = res["act_seq"]
    in_box = all(bool(((a >= lower) & (a <= upper)).all())
                 for a in (acts0, acts1, best[None]))
    best_out = res["best_model_output"]["state_seqs"]
    finite = all(bool(torch.isfinite(x).all()) for x in (
        r0, r1, states0, seen["states"][1], best_out,
        res["best_eval_output"]["reward_seqs"]))

    # card against CPU on a few samples of iteration 0, the same draws
    idx = [0, int(torch.argmax(r0)), n_sample - 1][:PLAN_CPU_SAMPLES]
    cpu_roll = make_batched_dynamics(cpu, tc)

    def cpu_run(nudge):
        cst, cmk, cph = inputs("cpu", nudge)
        _, cerr, _, cbbox = plan_evaluator(tc, cst, cmk, target)
        sub = acts0[idx].cpu()
        cs = cpu_roll(cpu_params, cst, cmk, sub, cph)["state_seqs"]
        return cs, running_cost_parts(cs, sub, cst, cerr, pen, cbbox,
                                      obj_mask=cmk)

    with torch.no_grad():
        card_parts = running_cost_parts(states0[idx], acts0[idx], st, err,
                                        pen, bbox, obj_mask=mk)
    cmp = card_against_cpu(states0[idx], card_parts, cpu_run)
    d_state, s_state = cmp["state_max"], cmp["state_spread"]
    d_parts, s_parts = cmp["parts_max"], cmp["parts_spread"]
    state_atol, parts_atol = cmp["state_atol"], cmp["parts_atol"]

    # chunking is a memory layout: the same population in one chunk
    one = make_batched_dynamics(card, dict(tc, n_sample_chunk=0))
    with torch.no_grad():
        whole = one(params, st, mk, acts0, phys)["state_seqs"]
    per_sample = (whole - states0).abs().flatten(1).amax(1)
    d_chunk = float(per_sample.max())
    r = {"phase": "plan_mppi", "samples": n_sample, "chunk": chunk,
         "chunks": -(-n_sample // chunk) if chunk else 1,
         "iterations": PLAN_ITERS, "max_nobj": n_max,
         "nodes": n_max + len(tc["pusher_points"]), "objects": len(pts),
         "repeats": [int(tc["action_lower_lim"][3]),
                     int(tc["action_upper_lim"][3])],
         "target_points": len(target), "seconds_mppi": secs,
         "mppi_samples_per_s": n_sample * PLAN_ITERS / secs,
         "peak_memory_bytes": int(peak),
         "best_act": best.cpu().tolist(),
         "best_reward": float(res["best_eval_output"]["reward_seqs"][0]),
         "reward_range_by_iteration": [[float(x.min()), float(x.max())]
                                       for x in (r0, r1)],
         "iteration1_sample0_is_incumbent": bool(torch.equal(acts1[0],
                                                             incumbent)),
         "actions_in_box": in_box, "finite": finite,
         "contact_launches": counts,
         "cpu_samples": idx, "card_vs_cpu_state_max": d_state,
         "cpu_nudged_state_spread": s_state, "state_atol": state_atol,
         "card_vs_cpu_parts_max": d_parts, "cpu_nudged_parts_spread": s_parts,
         "parts_atol": parts_atol, "chunked_vs_one_chunk_max": d_chunk,
         "chunked_vs_one_chunk_samples_differing": int((per_sample > 0).sum())}
    r["ok"] = bool(r["iteration1_sample0_is_incumbent"] and in_box and finite
                   and not any(counts.values()) and d_state <= state_atol
                   and max(d_parts.values()) <= parts_atol
                   and d_chunk <= state_atol and len(seen["acts"]) == 2)
    r["seconds"] = time.perf_counter() - t0
    emit(r)
    if not r["ok"]:
        raise RuntimeError("the planning path's check failed")

    # the chunk's numbers: the forward in each mode and the edge rebuild on
    # the first chunk's first graph (CUDA events), then one chunk's rollout
    # (max_repeat repeats) under the profiler
    _phase[0] = "plan_times"
    t0 = time.perf_counter()
    args, kwargs = seen["graph"]
    b, n = args[0].shape[0], args[0].shape[2]
    e = args[2].shape[1]
    times = {}
    with torch.no_grad():
        for mode in ("matmul", "segment", "slotted", "slotmm"):
            model = card if mode == "matmul" else gnn_model(
                mc, dev, sd, **dict(base, aggregation=mode))
            times[mode] = event_ms(lambda: model(*args, **kwargs), 2, warm=1)
            del model
        attrs = args[1]
        state_mask = (attrs[..., 0] > 0) | (attrs[..., 1] > 0)
        eef_mask = attrs[..., 1] > 0
        edge_ms = event_ms(lambda: build_edges_slotted_batch(
            args[0][:, -1], float(tc["adj_thresh"]), state_mask, eef_mask,
            topk=int(tc["topk"]), connect_tools_all=bool(
                tc["connect_tools_all"])), 3, warm=1)
        max_repeat = int(tc["action_upper_lim"][3])
        prof = profiled(lambda: rollout(params, st, mk, acts0[:b], phys),
                        max_repeat)
    prof.pop("profile")
    # the forward's bound: the dense layers' operations (what every mode
    # computes) against its inputs and weights read once and its two
    # (b, n_max, 3) outputs written once; matmul mode's one-hot products
    # are its own overhead, reported beside the bound
    ops, one_hot_ops = forward_ops(b, n, n_max, e,
                                   dataclasses.replace(mc, **base))
    tensors = [t for t in (*args, *kwargs.values(), *params.values())
               if torch.is_tensor(t)]
    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
              + 2 * b * n_max * 3 * 4)
    fwd_bound, fwd_by = bound(nbytes, ops)
    r = {"phase": "plan_times", "chunk_samples": b, "nodes": n, "edges": e,
         "forward_chunk_ms_by_mode": times, "forward_chunk_ops": ops,
         "forward_chunk_bytes": nbytes,
         "forward_chunk_bound_ms": fwd_bound, "bound_by": fwd_by,
         "matmul_one_hot_ops": one_hot_ops,
         "matmul_one_hot_ms_at_f32_peak": bound(0, one_hot_ops)[0],
         "edge_rebuild_chunk_ms": edge_ms,
         "launches_per_repeat": prof["kernel_launches_per_frame"],
         "device_busy_ms_per_repeat": prof["device_busy_ms_per_frame"],
         "device_idle_share": prof["device_idle_share"],
         "profiled_wall_ms_per_repeat": prof["wall_ms_per_frame"],
         "top_kernels": prof["top_kernels"][:6], "ok": True,
         "seconds": time.perf_counter() - t0}
    emit(r)
    return {"mppi_samples_per_s": n_sample * PLAN_ITERS / secs,
            "seconds_mppi": secs, "samples": n_sample, "chunk": chunk,
            "peak_memory_bytes": int(peak),
            "forward_chunk_ms_by_mode": times,
            "forward_chunk_bound_ms": fwd_bound,
            "matmul_one_hot_ms_at_f32_peak": r[
                "matmul_one_hot_ms_at_f32_peak"],
            "edge_rebuild_chunk_ms": edge_ms,
            "launches_per_repeat": r["launches_per_repeat"],
            "device_busy_ms_per_repeat": r["device_busy_ms_per_repeat"],
            "device_idle_share": r["device_idle_share"],
            "card_vs_cpu_state_max": d_state,
            "chunked_vs_one_chunk_max": d_chunk,
            "contact_launches": counts}


def loop_setup(dev, config=None, seed=SIM_SEED, task_over=None):
    """The planning loop's environment and task: SimPlanEnv on `config`
    (the rope's data-gen config at SIM_CUTS when None), the rope planning
    task with its pcd target built from the first observation (LOOP_SHIFT
    in the plan frame, written as plan() reads a target) and its action box
    and bbox recentred on the rope, and GNN_SEED's weights (a CPU
    state_dict); `task_over` replaces entries of the task. Returns {'env',
    'task', 'params', 'config', 'dir'}: the target lives in 'dir', a
    temporary directory the caller removes."""
    import tempfile

    from adaptigraph_torch.dynamics.model import model_config_from_yaml
    from adaptigraph_torch.planning import plan as plan_mod
    from adaptigraph_torch.utils import load_config
    from adaptigraph_torch.utils.host_fps import fps_with_idx

    _phase[0] = "loop_setup"
    t0 = time.perf_counter()
    cfg = config or load_config("data_gen/rope")
    if config is None:
        cfg["dataset"].update(SIM_CUTS)
    sim_env, secs_env = sync_time(lambda: plan_mod.SimPlanEnv(
        cfg, seed=seed, device=dev))
    senv = sim_env.env
    tc = dict(load_config("planning/rope")["task_config"])
    tc.update(task_over or {})
    ratio = float(tc["sim_real_ratio"])
    n_max = int(tc["max_nobj"])
    dyn = load_config(tc["config"])
    mc = model_config_from_yaml(dyn["model_config"], dyn["dataset_config"],
                                int(tc["material_dims"][tc["material"]]))
    params = {k: v.detach().cpu() for k, v in gnn_model(mc, "cpu")
              .state_dict().items()}
    # the target: the first observation's cloud, moved by LOOP_SHIFT in the
    # plan frame, then in the form plan() reads (flex z, / ratio)
    pm = plan_mod.PerceptionModule(tc)
    goal = plan_mod.capture_goal(sim_env, pm)
    n_tgt = min(2 * n_max, max(20, len(goal)))
    if len(goal) > n_tgt:
        goal, _ = fps_with_idx(goal.astype(np.float32), n_tgt)
    tgt_plan = plan_mod.flex_to_plan(goal) + np.asarray(LOOP_SHIFT,
                                                        np.float32)
    tmp = tempfile.mkdtemp(prefix="loop_path_")
    tgt_path = os.path.join(tmp, "target_pcd.npy")
    np.save(tgt_path, plan_mod.flex_to_plan(tgt_plan) / ratio)
    tc.update(target_type="pcd", target=tgt_path)
    # the action box and the workspace recentred on the rope
    rope0 = senv.get_positions()
    cx, cz = float(rope0[:, 0].mean()), float(rope0[:, 2].mean())
    lo, hi = tc["action_lower_lim"], tc["action_upper_lim"]
    tc["action_lower_lim"] = [cx - 4.5, -cz - 4.5, lo[2], lo[3]]
    tc["action_upper_lim"] = [cx + 4.5, -cz + 4.5, hi[2], hi[3]]
    bb, half = tc["bbox"], 0.55
    tc["bbox"] = [cx / ratio - half, bb[1], -cz / ratio - half,
                  cx / ratio + half, bb[4], -cz / ratio + half]
    emit({"phase": "loop_setup", "ok": True, "seconds_env": secs_env,
          "n_active": senv.n_active, "cap": senv.caps_ep.n,
          "shape_slots": int(senv.state.shapes.kind.shape[0]),
          "target_points": len(goal), "target_shift_plan": LOOP_SHIFT,
          "rope_centre_flex_xz": [cx, cz],
          "action_box": [tc["action_lower_lim"], tc["action_upper_lim"]],
          "bbox": tc["bbox"], "seconds": time.perf_counter() - t0})
    return {"env": sim_env, "task": tc, "params": params, "config": cfg,
            "dir": tmp}


def loop_phases(dev, config=None, seed=SIM_SEED, n_sample=LOOP_SAMPLES,
                task_over=None):
    """The closed planning loop on the card: planning.plan.plan() on
    SimPlanEnv (perceive, MPPI, push, perceive, log, refit) at the rope's
    full width, toward a target built from the card's own first
    observation. `config` (the data-gen config) defaults to the rope's at
    SIM_CUTS; n_sample and task_over (entries of the task) replace the
    loop's for a rehearsal on the CPU. The loop's stages are timed by
    wrapping what plan() calls (the env, the perception module, the
    planner, the physics optimiser); plan() itself runs as a user runs
    it. Gates: the
    perception, the MPPI step against the CPU, the push's launches, the
    artefacts. Returns what the kernels line and the numbers need."""
    import shutil

    from adaptigraph_torch.ops import chamfer
    from adaptigraph_torch.planning import perception
    from adaptigraph_torch.planning import plan as plan_mod
    from adaptigraph_torch.planning.actions import optimize_action_mppi
    from adaptigraph_torch.planning.costs import running_cost_parts
    from adaptigraph_torch.planning.forward_dynamics import (
        make_batched_dynamics)
    from adaptigraph_torch.utils import load_config

    setup = loop_setup(dev, config, seed, task_over)
    sim_env, tc, params, tmp = (setup[k] for k in ("env", "task", "params",
                                                   "dir"))
    cfg, senv, n_max = setup["config"], sim_env.env, int(tc["max_nobj"])
    try:
        # plan() as a user runs it, its collaborators wrapped to time them
        rec = {k: [] for k in ("observe", "perceive", "plan", "push", "log",
                               "ppo_refit", "clouds", "planners",
                               "push_frames", "push_s", "stepped",
                               "voxel_in", "voxel_out", "outlier_s",
                               "phys")}

        class LoopEnv:
            units = "sim"
            cam_intr, cam_extr = sim_env.cam_intr, sim_env.cam_extr

            def get_obs(self):
                out, secs = sync_time(sim_env.get_obs)
                rec["observe"].append(secs)
                return out

            def step(self, action):
                out, secs = sync_time(lambda: sim_env.step(action))
                rec["push"].append(secs)
                rec["stepped"].append(out is not None)
                rec["push_frames"].append(senv.stats["push"]["frames"])
                rec["push_s"].append(senv.stats["push"]["seconds"])
                return out

        class LoopPerception(plan_mod.PerceptionModule):
            def get_state_cur(self, *a, **k):
                t1 = time.perf_counter()
                st, cloud = super().get_state_cur(*a, **k)
                rec["perceive"].append(time.perf_counter() - t1)
                rec["clouds"].append((st, cloud, senv.get_positions()))
                return st, cloud

        class LoopPlanner(plan_mod.Planner):
            def __init__(self, config):
                super().__init__(config)
                self.samples, self.rewards = [], []
                evaluate = self.evaluate_traj

                def recorded(state_seqs, act_seqs, **kw):
                    out = evaluate(state_seqs, act_seqs, **kw)
                    if act_seqs.shape[0] == self.n_sample:
                        self.rewards.append(out["reward_seqs"])
                    return out

                self.evaluate_traj = recorded
                rec["planners"].append(self)

            def _sample(self, act_seq, noise, i):
                out = super()._sample(act_seq, noise, i)
                self.samples.append(out)
                return out

            def trajectory_optimization(self, state_cur, act_seq, seed=0):
                self.state_cur = state_cur
                self.res, secs = sync_time(lambda: super(
                    LoopPlanner, self).trajectory_optimization(
                        state_cur, act_seq, seed=seed))
                rec["plan"].append(secs)
                return self.res

        class LoopOptimizer(plan_mod.PhysicsParamOnlineOptimizer):
            def log_interaction(self, *a, **k):
                rec["phys"].append(self.physics_param[self.material].copy())
                t1 = time.perf_counter()
                super().log_interaction(*a, **k)
                rec["log"].append(time.perf_counter() - t1)

            def optimize(self, *a, **k):
                out, secs = sync_time(lambda: super(
                    LoopOptimizer, self).optimize(*a, **k))
                rec["ppo_refit"].append(secs)
                return out

        voxel, outliers = (perception.voxel_downsample,
                           perception.remove_statistical_outliers)

        def voxel_counted(pts, v):
            out = voxel(pts, v)
            rec["voxel_in"].append(len(pts))
            rec["voxel_out"].append(len(out))
            return out

        def outliers_timed(pts, *a, **k):
            t1 = time.perf_counter()
            out = outliers(pts, *a, **k)
            rec["outlier_s"].append(time.perf_counter() - t1)
            return out

        wrapped = {(plan_mod, "PerceptionModule"): LoopPerception,
                   (plan_mod, "Planner"): LoopPlanner,
                   (plan_mod, "PhysicsParamOnlineOptimizer"): LoopOptimizer,
                   (perception, "voxel_downsample"): voxel_counted,
                   (perception, "remove_statistical_outliers"):
                       outliers_timed}
        saved = {k: getattr(*k) for k in wrapped}
        ppo_iters = os.environ.get("PPO_ITERS")
        _phase[0] = "loop_path"
        save = os.path.join(tmp, "plan")
        try:
            for (mod, name), obj in wrapped.items():
                setattr(mod, name, obj)
            os.environ["PPO_ITERS"] = str(LOOP_PPO_ITERS)
            reset_counts()
            np.random.seed(seed)  # perception's FPS start
            stats, secs = sync_time(lambda: plan_mod.plan(
                tc, LoopEnv(), save, params, use_ppo=True,
                n_actions=LOOP_ACTIONS, n_sample=n_sample,
                n_update_iter=PLAN_ITERS, seed=LOOP_SEED, device=dev))
            counts = read_counts()
        finally:
            for (mod, name), obj in saved.items():
                setattr(mod, name, obj)
            if ppo_iters is None:
                os.environ.pop("PPO_ITERS", None)
            else:
                os.environ["PPO_ITERS"] = ppo_iters

        # perception: every perceived point near an active rope particle
        far = [float(np.linalg.norm(cloud[:, None] - rope[None], axis=-1)
                     .min(1).max()) if len(cloud) else float("inf")
               for _, cloud, rope in rec["clouds"]]
        nodes = [len(st) for st, _, _ in rec["clouds"]]
        # MPPI: the box, the incumbent, the chosen push against the CPU
        card_r = plan_mod.make_reward(tc, "target", dev)
        cpu_r = plan_mod.make_reward(tc, "target", "cpu")
        cpu_model = plan_mod.load_model(tc, params, "cpu")
        cpu_roll = make_batched_dynamics(cpu_model, tc)
        checks = []
        for i, pl in enumerate(rec["planners"]):
            res = pl.res
            acts0, acts1 = pl.samples
            inc = optimize_action_mppi(acts0, pl.rewards[0],
                                       pl.reward_weight, pl.lower, pl.upper,
                                       pl.push_length)
            best = res["act_seq"]
            in_box = bool(((best >= pl.lower) & (best <= pl.upper)).all())
            st = pl.state_cur
            mk = torch.as_tensor(np.arange(n_max) < nodes[2 * i], device=dev)
            phys = rec["phys"][i]
            with torch.no_grad():
                card_parts = running_cost_parts(
                    res["best_model_output"]["state_seqs"], best[None], st,
                    lambda f, m: card_r.error(f, card_r.target, None, m),
                    card_r.penalty, card_r.bbox, obj_mask=mk)

            def cpu_run(nudge, st=st, mk=mk, best=best, phys=phys):
                cst = st.cpu()
                if nudge:
                    cst = cst + torch.as_tensor(np.random.RandomState(1).randn(
                        *cst.shape).astype(np.float32) * nudge) * mk.cpu()[
                            :, None]
                cmk, act = mk.cpu(), best[None].cpu()
                cs = cpu_roll(dict(cpu_model.state_dict()), cst, cmk, act,
                              torch.as_tensor(phys))["state_seqs"]
                return cs, running_cost_parts(
                    cs, act, cst,
                    lambda f, m: cpu_r.error(f, cpu_r.target, None, m),
                    cpu_r.penalty, cpu_r.bbox, obj_mask=cmk)

            cmp = card_against_cpu(res["best_model_output"]["state_seqs"],
                                   card_parts, cpu_run)
            checks.append({
                "action": i, "act": best.cpu().tolist(), "in_box": in_box,
                "iteration1_sample0_is_incumbent": bool(torch.equal(
                    acts1[0], inc)),
                "physics_param": float(phys[0]),
                "card_vs_cpu_state_max": cmp["state_max"],
                "cpu_nudged_state_spread": cmp["state_spread"],
                "state_atol": cmp["state_atol"],
                "card_vs_cpu_parts_max": cmp["parts_max"],
                "parts_atol": cmp["parts_atol"], "ok": cmp["ok"]})

        # the artefacts plan() wrote
        names = sorted(os.listdir(save))
        inter = np.load(os.path.join(save, "interaction_000.npz"))
        table = np.loadtxt(os.path.join(save, "stats.txt"), ndmin=2)
        est = np.load(os.path.join(save, "ppo_0.npz"))["physics_param"]
        # the perceived cloud (FPS-free, so only a change of the frames
        # moves it) from before the first push to after the last
        (_, first, rope_first), (_, last, rope_last) = (rec["clouds"][0],
                                                        rec["clouds"][-1])
        moved = float(chamfer(torch.as_tensor(first), torch.as_tensor(last)))
        pushed = float(np.abs(rope_last - rope_first).max())
        frames = sum(rec["push_frames"])
        iters = senv.substeps * senv.iterations
        full = load_config("planning/rope")["task_config"]
        per_action = {k: sum(rec[k]) / LOOP_ACTIONS for k in (
            "observe", "perceive", "plan", "push", "log", "ppo_refit")}
        r = {"phase": "loop_path", "seconds": secs, "actions": LOOP_ACTIONS,
             "samples": n_sample, "iterations": PLAN_ITERS,
             "chunk": int(tc.get("n_sample_chunk", 0) or 0),
             "max_nobj": n_max, "ppo_iters": LOOP_PPO_ITERS,
             "cuts": {"samples": f"{n_sample} of {full['n_sample']}",
                      "actions": f"{LOOP_ACTIONS} of {full['n_actions']}",
                      "ppo_iters": f"{LOOP_PPO_ITERS} of 50",
                      "push": {k: cfg["dataset"].get(k) for k in SIM_CUTS},
                      "action_box_and_bbox": "recentred on the rope"},
             "seconds_per_action": per_action,
             "perceived_nodes": nodes, "farthest_point_from_rope": far,
             "points_before_voxel": rec["voxel_in"],
             "points_after_voxel": rec["voxel_out"],
             "outlier_pass_seconds": rec["outlier_s"],
             "mppi_samples_per_s": n_sample * PLAN_ITERS * LOOP_ACTIONS
             / sum(rec["plan"]),
             "push_frames": frames,
             "push_frames_per_s": frames / sum(rec["push_s"]),
             "launches": counts, "pushes_ok": rec["stepped"],
             "mppi": checks,
             "stats": table.tolist(),
             "predicted_vs_real_error": [[float(row[3]), float(row[2])]
                                         for row in table],
             "physics_estimate": [float(x) for x in np.ravel(est)],
             "perceived_cloud_change_chamfer": moved,
             "rope_max_displacement": pushed,
             "artefacts": names}
        r["ok"] = bool(
            all(1 <= n <= n_max for n in nodes)
            and max(far) <= LOOP_PERCEIVE_DIST
            and all(c["in_box"] and c["iteration1_sample0_is_incumbent"]
                    and c["ok"] for c in checks)
            and len(checks) == LOOP_ACTIONS
            and counts["k1"] == iters * frames and counts["k2"] == frames
            and counts["k3"] == 0 and counts["k4"] == 0
            and frames > 0 and all(rec["stepped"])
            and moved >= LOOP_MOVED and pushed >= LOOP_PUSHED
            and sorted(inter.files) == ["act", "state_init", "state_pred",
                                        "state_real"]
            and table.shape == (LOOP_ACTIONS, 4) and np.isfinite(table).all()
            and bool(np.all((est >= -0.2) & (est <= 1.2)))
            and len(stats) == LOOP_ACTIONS)
        emit(r)
        if not r["ok"]:
            raise RuntimeError("the planning loop's check failed")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"counts": counts, "push_frames": frames,
            "seconds": secs, "seconds_per_action": per_action,
            "mppi_samples_per_s": r["mppi_samples_per_s"],
            "push_frames_per_s": r["push_frames_per_s"],
            "card_vs_cpu_state_max": max(c["card_vs_cpu_state_max"]
                                         for c in checks),
            "predicted_vs_real_error": r["predicted_vs_real_error"],
            "physics_estimate": r["physics_estimate"]}


def sparse_phase(dev, b, pos_traj, quat_traj, pushed, t_check):
    """The rope at 5,120 particles in sparse mode on the card: its neighbor
    list from the cell list (above 1,024 particles), no contact kernel,
    and card frames against CPU frames. Returns the path's counts."""
    from adaptigraph_torch.engine.cells import cell_bucket_overflow
    from adaptigraph_torch.engine.solver import rollout_steps
    from adaptigraph_torch.engine.state import tree_to

    _phase[0] = "sparse_path"
    spec, prm = b.spec, b.spec.params
    p = b.state.particles
    n = p.pos.shape[0]
    kw = dict(contact_mode="sparse")
    rollout_steps(b.state, spec, pos_traj[:1], quat_traj[:1], b.substeps,
                  b.iterations, record=False, **kw)  # warm-up
    reset_counts()
    (fin, rec), secs = sync_time(lambda: rollout_steps(
        b.state, spec, pos_traj[:T_SPARSE], quat_traj[:T_SPARSE],
        b.substeps, b.iterations, **kw))
    counts = read_counts()
    finite = bool(torch.isfinite(rec).all())
    overflow = int(cell_bucket_overflow(p.pos, prm.radius * 1.5, p.active))
    emit({"phase": "sparse_path", "n": n,
          "neighbor_find": "cell_list_neighbors" if n > 1024
          else "neighbor_list", "frames": T_SPARSE, "seconds": secs,
          "frames_per_s": T_SPARSE / secs, "launches": counts,
          "cell_bucket_overflow": overflow, "finite": finite,
          "max_displacement": float((rec[-1] - p.pos).abs().max())})
    iters = b.substeps * b.iterations
    if (n <= 1024 or any(counts[k] for k in ("k1", "k2", "k3", "k4"))
            or counts["unfused_shape_pass"] != iters * T_SPARSE
            or not finite):
        raise RuntimeError("sparse path check failed")

    # card against CPU, 3 frames: from the built scene (free fall), held to
    # FRAME_ATOL, and from the rope's check frame (contacts), held as the
    # block mode's contact windows are. That max gate sits below the CPU's
    # own max spread under a 1e-6 nudge on this window (a contact decision
    # flips under the nudge): it holds only while card and CPU take the
    # same contact decisions, and so says more of the median than of the
    # max
    _phase[0] = "sparse_frame_agreement"
    t0 = time.perf_counter()
    spec_cpu = tree_to(spec, "cpu")

    def three(state, start, device):
        sl = slice(start, start + 3)
        return rollout_steps(
            tree_to(state, device), spec if device != "cpu" else spec_cpu,
            pos_traj[sl], quat_traj[sl], b.substeps, b.iterations,
            **kw)[1].cpu()

    free = float((three(b.state, 0, dev) - three(b.state, 0, "cpu"))
                 .abs().max())
    g, cpu = three(pushed, t_check + 1, dev), three(pushed, t_check + 1,
                                                    "cpu")
    cn = three(nudged(pushed), t_check + 1, "cpu")
    per_particle = (g - cpu).abs().amax(dim=(0, 2))
    max_atol = float(CONTACT_MAX_FRAC * prm.solid_rest_distance)
    r = {"phase": "sparse_frame_agreement", "frames": 3,
         "from_built_scene_max": free, "free_fall_atol": FRAME_ATOL,
         "check_frame": t_check + 1,
         "card_vs_cpu_max": float(per_particle.max()),
         "card_vs_cpu_median": float(per_particle.median()),
         "cpu_vs_cpu_nudged_1e-6_max": float((cn - cpu).abs().max()),
         "contact_median_atol": CONTACT_MEDIAN_ATOL,
         "contact_max_atol": max_atol,
         "seconds": time.perf_counter() - t0}
    r["ok"] = (free <= FRAME_ATOL
               and r["card_vs_cpu_median"] <= CONTACT_MEDIAN_ATOL
               and r["card_vs_cpu_max"] <= max_atol)
    emit(r)
    if not r["ok"]:
        raise RuntimeError("card and CPU sparse frames disagree")

    # what rounding squared distances as the JAX package's CPU does
    # (neighbors.sq_dist_fma, worked in float64) costs on the card beside
    # the plain float32 sum, at this path's sizes: the cell list's
    # candidate differences (N, 27 x bucket 8, 3) and the rest filter's
    # (N, K 24, 3), each once a frame
    _phase[0] = "sparse_sq_dist_cost"
    from adaptigraph_torch.engine.neighbors import sq_dist, sq_dist_fma
    gen = torch.Generator(device=dev).manual_seed(0)
    cost = {}
    for name, shape in (("cell_list", (n, 27 * 8, 3)),
                        ("rest_filter", (n, 24, 3))):
        d = torch.randn(shape, device=dev, generator=gen)
        cost[name] = {"fma_f64_ms": event_ms(lambda: sq_dist_fma(d), 50),
                      "plain_f32_ms": event_ms(lambda: sq_dist(d), 50)}
    emit({"phase": "sparse_sq_dist_cost", "ok": True, "per_call": cost,
          "extra_ms_per_frame": sum(c["fma_f64_ms"] - c["plain_f32_ms"]
                                    for c in cost.values()),
          "sparse_ms_per_frame": 1e3 * secs / T_SPARSE})
    return counts


def main():
    watchdog()
    t_start = time.perf_counter()

    _phase[0] = "device"
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    dev = torch.device(DEVICE)
    torch.cuda.set_device(0)

    import adaptigraph_torch.engine.contact_kernels as ck
    from adaptigraph_torch.engine.solver import rollout_steps
    from adaptigraph_torch.engine.state import tree_to
    from adaptigraph_torch.kernels import build
    from adaptigraph_torch.scenes.design_point import (
        pusher_sweep, rope_design_point)

    _phase[0] = "build"
    t0 = time.perf_counter()
    log = build.build(timeout=240)
    lib = build.load()
    ptxas = [ln.strip() for ln in (log or "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "compiled": log is not None, "ptxas": ptxas})

    _phase[0] = "scene"
    t0 = time.perf_counter()
    b = rope_design_point(dev)
    spec = b.spec
    pos_traj, quat_traj = pusher_sweep(b, T_MAIN)
    # the kernel checks need a frame with particle contacts: step the first
    # T_PUSH frames one at a time and take the frame whose first solver
    # iteration meets the most (a sweep with no contacts proves nothing)
    st, found = b.state, []
    for t in range(T_PUSH):
        st, _ = rollout_steps(st, spec, pos_traj[t:t + 1], quat_traj[t:t + 1],
                              b.substeps, b.iterations, record=False)
        found.append((frame_contacts(st, spec), t, st))
    best, t_check, pushed = max(found, key=lambda f: (f[0], -f[1]))
    by_frame = [f[0] for f in found]
    # the state one frame before the first frame with contacts, for the
    # frame-agreement window across the contact onset
    t_on = next((t for t, c in enumerate(by_frame) if c > 0), t_check)
    before_onset = found[t_on - 1][2] if t_on > 0 else b.state
    del found
    torch.cuda.synchronize()
    movable = int(((b.state.particles.inv_mass > 0)
                   & b.state.particles.active).sum())
    emit({"phase": "scene", "ok": True, "n_active": b.n_active,
          "movable": movable, "clusters": int(spec.clusters.valid.sum()),
          "substeps": b.substeps, "iterations": b.iterations,
          "searched_frames": T_PUSH, "check_frame": t_check,
          "check_frame_contacts": best, "contacts_by_frame": by_frame,
          "seconds": time.perf_counter() - t0})
    if movable == 0:
        raise RuntimeError("every particle is pinned")

    # K2 against its plain version: the block lists must be equal in full.
    # On the check frame K2 keeps every listed block (contacts everywhere,
    # and the moving pusher widens the keep distance to its cap); on the
    # built scene (nothing moving, the lattice's pairs rest-filtered) it
    # drops blocks, so the compaction order is exercised too.
    _phase[0] = "k2_check"
    k2_report, k2_err = [], 0
    frames = (("check", pushed), ("built", b.state))
    for (frame, state), tile_j, rf in itertools.product(frames, (128, 256),
                                                        (True, False)):
        a = kernel_inputs(state, spec, tile_j, granular_groups=not rf)
        args = (a["rows"], a["cols"], a["keep"], a["prm"].collide_filter_dist,
                a["idx"], a["cnt"])
        ki, kc = ck.refine_overlap_blocks_packed(
            a["n"], *args, rest_filter=rf, tile_j=tile_j)
        pi, pc = ck.refine_blocks_plain(*args, rest_filter=rf, tile_j=tile_j)
        same = bool(torch.equal(ki, pi) and torch.equal(kc, pc))
        err = max(int((ki - pi).abs().max()), int((kc - pc).abs().max()))
        k2_err = max(k2_err, err)
        k2_report.append({"frame": frame, "keep_dist": float(a["keep"]),
                          "tile_j": tile_j, "rest_filter": rf,
                          "equal": same, "max_abs_err": err,
                          "listed": int(a["cnt"].sum()),
                          "kept": int(kc.sum()), "overflow": a["overflow"]})
        if not same:
            raise RuntimeError(f"K2 disagrees with its plain version: "
                               f"{k2_report[-1]}")
    emit({"phase": "k2_check", "ok": True, "cases": k2_report})

    # K1 against its plain version, over the refined lists
    _phase[0] = "k1_check"
    k1_report, k1_err = [], 0.0
    for tile_j in (128, 256):
        for rf in (True, False):
            a = kernel_inputs(pushed, spec, tile_j, granular_groups=not rf)
            prm = a["prm"]
            ridx, rcnt = ck.refine_blocks_plain(
                a["rows"], a["cols"], a["keep"], prm.collide_filter_dist,
                a["idx"], a["cnt"], rest_filter=rf, tile_j=tile_j)
            args = (a["rows1"], a["cols1"], prm.solid_rest_distance,
                    prm.particle_friction, prm.collide_filter_dist, ridx, rcnt)
            kd, kc = ck.block_sparse_contact_deltas_packed(
                a["n"], *args, rest_filter=rf, tile_j=tile_j)
            pd, pc = ck.block_sparse_contact_plain(a["n"], *args,
                                                   rest_filter=rf,
                                                   tile_j=tile_j)
            err = float((kd - pd).abs().max())
            contacts = int(pc.sum())
            k1_err = max(k1_err, err)
            counts_equal = bool(torch.equal(kc, pc))
            again = repeats(lambda: ck.block_sparse_contact_deltas_packed(
                a["n"], *args, rest_filter=rf, tile_j=tile_j))
            k1_report.append({"tile_j": tile_j, "rest_filter": rf,
                              "counts_equal": counts_equal,
                              "contacts": contacts, "max_abs_err": err,
                              "repeats_bitwise": again,
                              "finite": bool(torch.isfinite(kd).all())})
            if (not counts_equal or not err <= K1_ATOL or contacts == 0
                    or not again):
                raise RuntimeError(f"K1 check failed: {k1_report[-1]}")
    emit({"phase": "k1_check", "ok": True, "atol": K1_ATOL,
          "cases": k1_report})

    # the main path, through the entry point a user calls
    _phase[0] = "main_path"
    rollout_steps(b.state, spec, pos_traj[:2], quat_traj[:2], b.substeps,
                  b.iterations, record=False)  # warm-up (cuBLAS, allocator)
    reset_counts()
    (final, rec), secs = sync_time(lambda: rollout_steps(
        b.state, spec, pos_traj, quat_traj, b.substeps, b.iterations))
    launches = read_counts()
    per_frame_iters = b.substeps * b.iterations
    overflow = int(final.contact_overflow)
    finite = bool(torch.isfinite(rec).all())
    moved = float((rec[-1] - b.state.particles.pos).abs().max())
    emit({"phase": "main_path", "frames": T_MAIN, "seconds": secs,
          "frames_per_s": T_MAIN / secs, "ms_per_frame": 1e3 * secs / T_MAIN,
          "launches": launches, "contact_overflow": overflow,
          "finite": finite, "max_displacement": moved})
    if (launches["k1"] != per_frame_iters * T_MAIN
            or launches["k2"] != T_MAIN or launches["k3"] != 0
            or launches["k4"] != 0 or overflow != 0 or not finite):
        raise RuntimeError("main path check failed")

    _phase[0] = "bench_pinned"
    bp = rope_design_point(dev, lifted=False)
    ptj, qtj = pusher_sweep(bp, T_BENCH)
    (fp, _), secs_p = sync_time(lambda: rollout_steps(
        bp.state, bp.spec, ptj, qtj, bp.substeps, bp.iterations,
        record=False))
    movable_p = int(((bp.state.particles.inv_mass > 0)
                     & bp.state.particles.active).sum())
    emit({"phase": "bench_pinned", "ok": True, "frames": T_BENCH,
          "movable": movable_p, "frames_per_s": T_BENCH / secs_p,
          "ms_per_frame": 1e3 * secs_p / T_BENCH,
          "finite": bool(torch.isfinite(fp.particles.pos).all())})

    # kernel and plain-version times at the rope main path's shapes
    _phase[0] = "kernel_times"
    a = kernel_inputs(pushed, spec, 128)
    prm = a["prm"]
    ridx, rcnt = ck.refine_blocks_plain(a["rows"], a["cols"], a["keep"],
                                        prm.collide_filter_dist, a["idx"],
                                        a["cnt"], tile_j=128)
    rope = k1_k2_times(
        dev, lib, a, (a["n"], a["rows1"], a["cols1"], prm.solid_rest_distance,
                      prm.particle_friction, prm.collide_filter_dist, ridx,
                      rcnt),
        (a["rows"], a["cols"], a["keep"], prm.collide_filter_dist, a["idx"],
         a["cnt"]), 128, True)
    times = rope["times"]
    (b1, by1), (b2, by2) = rope["k1_bound"], rope["k2_bound"]
    rope_geometry = rope["geometry"]
    # emitted with the granular kernels' times after the granular phases
    rope_times = {"times_ms": times, **rope["detail"]}

    # three frames on the card against three on the CPU from the same
    # state. From the built scene (free fall, no contact) the two differ by
    # rounding only, held to FRAME_ATOL. Then two windows with contacts:
    # across the contact onset (from the frame before the first one with
    # particle contacts) and from the check frame (the most contacts, the
    # rope on the floor). There a contact decision that rounding flips
    # changes a particle's Jacobi count, which divides all its other
    # corrections anew, so the frame is not continuous in its input and a
    # few particles part by far more than rounding; the CPU against itself
    # under a 1e-6 nudge of its input positions is reported beside it. Such
    # a window is held in bulk and in its tail: the median particle to
    # CONTACT_MEDIAN_ATOL (particles away from a flipped contact part by
    # rounding only) and every particle to CONTACT_MAX_FRAC of the contact
    # distance (a flip changes part of one contact correction; a wrong
    # frame moves particles by whole corrections).
    _phase[0] = "frame_agreement"
    spec_cpu = tree_to(spec, "cpu")

    def three(state, start, device):
        sl = slice(start, start + 3)
        fin, rec = rollout_steps(tree_to(state, device),
                                 spec if device != "cpu" else spec_cpu,
                                 pos_traj[sl], quat_traj[sl], b.substeps,
                                 b.iterations)
        return rec.cpu(), int(fin.contact_overflow)

    g0, og = three(b.state, 0, dev)
    c0, oc = three(b.state, 0, "cpu")
    diff0 = float((g0 - c0).abs().max())
    max_diff = float(CONTACT_MAX_FRAC * spec.params.solid_rest_distance)
    windows, failed = {}, []
    for name, state, start in (("contact_onset", before_onset, t_on),
                               ("check_frame", pushed, t_check + 1)):
        g, _ = three(state, start, dev)
        c, _ = three(state, start, "cpu")
        noise = np.random.RandomState(1).randn(*state.particles.pos.shape)
        nudged = state._replace(particles=state.particles._replace(
            pos=state.particles.pos + torch.as_tensor(
                noise * 1e-6, dtype=torch.float32, device=dev)))
        cn, _ = three(nudged, start, "cpu")
        per_particle = (g - c).abs().amax(dim=(0, 2))
        w = windows[name] = {
            "start": start,
            "first_iteration_contacts": by_frame[max(start - 1, 0):start + 2],
            "card_vs_cpu_max": float(per_particle.max()),
            "card_vs_cpu_median": float(per_particle.median()),
            "cpu_vs_cpu_nudged_1e-6_max": float((cn - c).abs().max()),
            "max_displacement": float(
                (c[-1] - state.particles.pos.cpu()).abs().max())}
        if not (w["card_vs_cpu_median"] <= CONTACT_MEDIAN_ATOL
                and w["card_vs_cpu_max"] <= max_diff):
            failed.append(name)
    emit({"phase": "frame_agreement", "frames": 3, "atol": FRAME_ATOL,
          "from_built_scene": {"max_abs_diff": diff0,
                               "max_displacement": float(
                                   (c0[-1] - b.state.particles.pos.cpu())
                                   .abs().max()),
                               "overflow": [og, oc]},
          "contact_median_atol": CONTACT_MEDIAN_ATOL,
          "contact_max_atol": max_diff, **windows})
    if not diff0 <= FRAME_ATOL:
        raise RuntimeError("card and CPU frames from the built scene "
                           "disagree")
    if failed:
        raise RuntimeError(f"card and CPU frames disagree in {failed}")

    # the learned step over this path's push: the rope's recorded positions
    # are the object track, the box's centre the one tool point
    gnn = gnn_phases(dev, rec[:, :b.n_active].cpu().numpy(),
                     pos_traj[:, 1:2].astype(np.float64))
    # MPPI on the learned step: the current state is this path's last
    # recorded frame, the target is made from its middle frame
    plan = plan_phases(dev, rec[-1, :b.n_active].cpu().numpy(),
                       rec[T_MAIN // 2, :b.n_active].cpu().numpy())
    del rec
    sparse_counts = sparse_phase(dev, b, pos_traj, quat_traj, pushed, t_check)
    gran = granular_phases(dev, lib)
    gt = gran["times"]
    cloth = cloth_phases(dev, lib)
    ct = cloth["times"]
    sim = sim_phases(dev, lib, after_episode=lambda dyn, root: train_phases(
        dev, dyn, root))
    simt = sim["times"]
    train = sim["after_episode"]
    loop = loop_phases(dev)
    batch = batch_phases(dev, lone=sim["lone"])
    native_phases(sim["frames"], sim["lone"]["settled"][:sim["n_active"]])

    # K2's edges: the granular design point's first frame after landing
    # (lists up to 20 blocks long, none kept), bench.py's pinned rope
    # (every block pruned),
    # and synthetic lists on the rope's check frame (tiles listing none,
    # tiles listing maxb, stale indices past each count) in K2's four forms
    _phase[0] = "k2_edges"
    cases = [("granular_landed", gran["k2_landed_args"], DESIGN["tile_j"],
              False)]
    a = kernel_inputs(bp.state, bp.spec, 128)
    cases.append(("bench_pinned", (a["rows"], a["cols"], a["keep"],
                                   a["prm"].collide_filter_dist, a["idx"],
                                   a["cnt"]), 128, True))
    for tile_j, rf in itertools.product((128, 256), (True, False)):
        a = kernel_inputs(pushed, spec, tile_j, granular_groups=not rf)
        nb, maxb = a["idx"].shape
        idx, cnt = edge_block_lists(nb, a["cols"].shape[1] // tile_j, maxb,
                                    seed=tile_j + rf)
        cases.append(("synthetic", (
            a["rows"], a["cols"], a["keep"], a["prm"].collide_filter_dist,
            torch.as_tensor(idx, device=dev),
            torch.as_tensor(cnt, device=dev)), tile_j, rf))
    edges = k2_edges(cases)
    ok = all(c["equal"] and c["repeats_bitwise"] for c in edges)
    emit({"phase": "k2_edges", "ok": ok, "cases": edges})
    if not ok:
        raise RuntimeError("K2 disagrees with its plain version on an edge "
                           "case")
    emit({"phase": "kernel_times", "ok": True, "rope": rope_times,
          "granular": {"times_ms": gt, **gran["detail"]},
          "cloth": {"times_ms": ct, **cloth["detail"]},
          "sim": {"times_ms": simt, **sim["detail"]},
          "library_ms": "null: no single PyTorch call computes any of the "
                        "four functions"})

    # launches: each path's counts, read just after it ran from zero
    by_path = {"rope_main_path": launches,
               "granular_path": gran["granular_counts"],
               "granular_dense_path": gran["dense_counts"],
               "cloth_path": cloth["counts"],
               "sim_path": sim["counts"],
               "sparse_path": sparse_counts,
               "plan_path": plan["contact_launches"],
               "loop_path": loop["counts"],
               "train_path": train["counts"],
               "batch_path": batch["counts"]}

    def total(key):
        return sum(c[key] for c in by_path.values())

    def per_path(key):
        return {p: c[key] for p, c in by_path.items()}

    src = "adaptigraph_torch/kernels/csrc/contact.cu"
    pk = "adaptigraph_tpu/engine/pallas_kernels.py"
    b3, by3 = gran["k3_bound"]
    b4, by4 = gran["k4_bound"]
    k4_alone = min(gt["k4_alone"], gt["k4_alone_b"])
    k1_empty = min(gt["k1_empty"], gt["k1_empty_b"])

    def at_design_point(key):
        ms, by = gran[f"{key}_bound"]
        return {"ms": min(gt[f"{key}_granular"], gt[f"{key}_granular_b"]),
                "plain_ms": min(gt[f"{key}_granular_plain_a"],
                                gt[f"{key}_granular_plain_b"]),
                "bound_ms": ms, "bound_by": by,
                "geometry": gran["geometry"][f"{key}_granular"],
                "timed_at": f"granular design point's last frame, tile_j "
                            f"{gran['detail']['k1_granular']['tile_j']}, "
                            f"rest_filter off"}

    def at_cloth(key):
        ms, by = cloth[f"{key}_bound"]
        return {"ms": min(ct[key], ct[f"{key}_b"]),
                "plain_ms": min(ct[f"{key}_plain_a"], ct[f"{key}_plain_b"]),
                "bound_ms": ms, "bound_by": by,
                "launches_per_frame": cloth["counts"][key] / T_CLOTH,
                "geometry": cloth["geometry"][key],
                "timed_at": f"cloth design point's frame {T_CLOTH} (the box "
                            f"pushing the landed sheet), tile_j 128, "
                            f"rest_filter on"}
    def at_sim(key):
        ms, by = sim[f"{key}_bound"]
        return {"ms": min(simt[key], simt[f"{key}_b"]),
                "plain_ms": min(simt[f"{key}_plain_a"], simt[f"{key}_plain_b"]),
                "bound_ms": ms, "bound_by": by,
                "launches_per_push": sim["counts"][key],
                "geometry": sim["geometry"][key],
                "timed_at": f"SimEnv rope's pushed frame "
                            f"{sim['detail'][key]['frame']} (episode "
                            f"{SIM_SEED}), tile_j 128, rest_filter on"}
    emit({"phase": "gnn_numbers", "gnn_path": gnn, "card": smi})
    emit({"phase": "plan_numbers", "plan_path": plan, "card": smi})
    emit({"phase": "loop_numbers", "loop_path": loop, "card": smi})
    emit({"phase": "train_numbers", "train_path": train, "card": smi})
    emit({"phase": "batch_numbers", "batch_path": batch, "card": smi})
    emit({"kernels": [
        {"name": "block_sparse_contact", "route": "cuda", "source": src,
         "replaces": f"{pk}:631",
         "launches": total("k1"), "launches_by_path": per_path("k1"),
         "max_abs_err": max(k1_err, gran["k1_err"], gran["k1_full_err"],
                            cloth["k1_err"], sim["k1_err"]),
         "ms": min(times["k1"], times["k1_b"]),
         "plain_ms": min(times["k1_plain_a"], times["k1_plain_b"]),
         "bound_ms": b1, "bound_by": by1, "library_ms": None,
         "geometry": rope_geometry["k1"],
         "timed_at": "rope check frame, tile_j 128, rest_filter on",
         "granular": at_design_point("k1"),
         "fused_granular_ms": min(gt["k1_fused_granular"],
                                  gt["k1_fused_granular_b"]),
         "cloth": at_cloth("k1"), "sim": at_sim("k1")},
        {"name": "refine_blocks", "route": "cuda", "source": src,
         "replaces": f"{pk}:487",
         "launches": total("k2"), "launches_by_path": per_path("k2"),
         "max_abs_err": float(k2_err),
         "ms": min(times["k2"], times["k2_b"]),
         "plain_ms": min(times["k2_plain_a"], times["k2_plain_b"]),
         "bound_ms": b2, "bound_by": by2, "library_ms": None,
         "geometry": rope_geometry["k2"],
         "timed_at": "rope check frame, tile_j 128, rest_filter on",
         "granular": at_design_point("k2"),
         "granular_landed": {
             "ms": min(gt["k2_landed"], gt["k2_landed_b"]),
             "plain_ms": min(gt["k2_landed_plain_a"],
                             gt["k2_landed_plain_b"]),
             "bound_ms": gran["k2_landed_bound"][0],
             "bound_by": gran["k2_landed_bound"][1],
             "timed_at": f"granular design point's frame {T_LANDED}, its "
                         f"first frame after landing"},
         "cloth": at_cloth("k2"), "sim": at_sim("k2")},
        {"name": "dense_contact", "route": "cuda", "source": src,
         "replaces": f"{pk}:712",
         "launches": total("k3"), "launches_by_path": per_path("k3"),
         "max_abs_err": gran["k3_err"],
         "ms": min(gt["k3"], gt["k3_b"]),
         "plain_ms": min(gt["k3_plain_a"], gt["k3_plain_b"]),
         "bound_ms": b3, "bound_by": by3, "library_ms": None,
         "geometry": gran["geometry"]["k3"],
         "timed_at": "dense band frame with the most contacts"},
        {"name": "shape_stage_fused", "route": "cuda", "source": src,
         "replaces": f"{pk}:137",
         "launches": total("k4"), "launches_by_path": per_path("k4"),
         "max_abs_err": gran["k4_err"],
         "ms": k4_alone - k1_empty,
         "plain_ms": min(gt["k4_plain_a"], gt["k4_plain_b"]),
         "bound_ms": b4, "bound_by": by4, "library_ms": None,
         "alone_ms": k4_alone, "k1_empty_ms": k1_empty,
         "fused_increment_ms": (
             min(gt["k1_fused_granular"], gt["k1_fused_granular_b"])
             - min(gt["k1_granular"], gt["k1_granular_b"])),
         "unfused_pass_ms": min(gt["unfused_shape_pass_a"],
                                gt["unfused_shape_pass_b"]),
         "geometry": gran["geometry"]["k1_granular"],
         "timed_at": "granular design point's last frame: the fused launch "
                     "over empty block lists less the unfused one (alone_ms "
                     "less k1_empty_ms); fused_increment_ms over the "
                     "frame's lists"},
    ]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # report the phase, then fail without a result
        traceback.print_exc()
        print(json.dumps({"phase": _phase[0], "ok": False,
                          "error": f"{type(e).__name__}: {e}"}), flush=True)
        sys.exit(1)

"""Typed configuration for the whole framework (the port's own copy).

A copy of ``slam_robot_tpu/config.py``: the same fields, defaults and
comments, so that a JAX-package config converts with
``SlamConfig(**dataclasses.asdict(cfg))``. The port keeps its own copy
so that importing it loads nothing of the JAX package.

The reference scatters its tuning constants through the code (survey §5:
baseline 150mm at main.cpp:496, focal 416 at main.cpp:474, patch window 13 at
matcher.cpp:27, min-match 40 at matcher.cpp:338/353, corner params at
matcher.cpp:125-130, seed depth 2000 at matcher.cpp:380, epipolar threshold
0.0015 at localmap.cpp:260, solve windows (2,5)/(10,20) at main.cpp:580-592,
error threshold 5 at main.cpp:555, turning radius 2 at planner.cpp:24).
Here they all live in one frozen dataclass, plus the fixed capacities the
TPU-native mask-based state layout needs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    # ---- image geometry (main.cpp:474-486, video.cpp:136-137) ----
    image_width: int = 640
    image_height: int = 480
    focal: float = 416.0           # fx; fy is -focal (y-flip baked into intrinsics)
    cx: float = 320.0
    cy: float = 240.0
    num_cameras: int = 2           # alternating stereo pair (main.cpp:507)
    baseline_mm: float = 150.0     # assumed stereo baseline (main.cpp:496)

    # ---- tracker (hessian.h, matcher.cpp) ----
    tracker_kind: str = "hessian"  # "hessian" | "klt" (FeatureTracker
                                   # typedef seam, matcher.cpp:21)
    tracker_impl: str = "fused"    # "fused": one Pallas kernel per pyramid
                                   # level sweep (ops/pallas/newton.py);
                                   # "lanes": vmapped per-feature autodiff
                                   # tracker (round-1 path). Same math —
                                   # tests/test_tracker_fused.py pins parity
    patch_size: int = 13           # kWindowSize (matcher.cpp:27)
    pyramid_depth: int = 6         # matcher.cpp:317
    track_threshold: float = 0.001  # convergence step threshold (matcher.cpp:176)
    track_max_iters: int = 6       # ref allows 10 with an early break
                                   # (matcher.cpp:176); with projection-
                                   # predicted starts 6 matches the same
                                   # features (measured) at -30% step time
                                   # — a batched while runs to the slowest
                                   # lane, so stragglers bill everyone
    track_iters_coarse: int = 0    # Newton budget at levels > 0 (0 =
                                   # uniform track_max_iters, the
                                   # reference behavior). MEASURED OFF at
                                   # 4: saved ~1 ms/frame but bench ATE
                                   # 0.93 -> 2.18%% — a coarse level that
                                   # stops short can hand the fine level
                                   # the wrong basin, and those matches
                                   # still pass the roundtrip gate
    roundtrip_px: float = 0.3      # fwd/bwd consistency gate (matcher.cpp:201)
    mask_bias: float = 15.0        # radial weight 1/(15+r^2) (hessian.h:18)
    blur_sigma0: float = 1.1       # level-0 Gaussian (hessian.h:102)
    blur_sigma_down: float = 0.8   # post-pyrDown Gaussian (hessian.h:113)
    levels_confident: int = 3      # uncertainty <= 100 (matcher.cpp:227-229)
    levels_unsure: int = 6

    # ---- feature lifecycle (matcher.cpp) ----
    min_matches: int = 40          # keyframe trigger (matcher.cpp:338,353)
    max_corners: int = 120         # goodFeaturesToTrack (matcher.cpp:127).
                                   # The detector pegs this cap on every
                                   # keyframe, and raising it to 200 fixes
                                   # the hard bench draw (3-seed on-chip
                                   # median 1.46 -> 0.97 % ATE) — but blows
                                   # up rotation-heavy scenes 2-8x (low-
                                   # parallax seeds weaken pose constraints;
                                   # capacity-independent). A per-regime
                                   # trade, not a default: PERF.md finding
                                   # 44 has the full campaign.
    corner_quality: float = 0.01   # matcher.cpp:128
    corner_min_dist: float = 20.0  # matcher.cpp:129
    suppress_grid: int = 30        # occupancy grid (matcher.cpp:132)
    seed_depth_mm: float = 2000.0  # new-point unproject depth (matcher.cpp:380)
    seed_depth_adaptive: bool = False  # seed at the median camera depth
                                   # of converged map points instead of
                                   # the fixed guess (fallback:
                                   # seed_depth_mm when <16 confident
                                   # points vote). MEASURED NEGATIVE as a
                                   # default (CPU bench sweep A/B): it
                                   # does flatten the per-segment
                                   # trajectory scale drift (1.022-1.049
                                   # -> 1.013-1.017 fits) but doubles ATE
                                   # (15.4 -> 28.9 mm) via a keyframe
                                   # storm (19 -> 30): far-seeded points
                                   # have near-zero parallax per frame, so
                                   # fresh maps constrain pose weakly and
                                   # tracking falls below min_matches more
                                   # often. Kept as a knob for deep scenes
                                   # where 2000 mm is badly wrong.
    max_views: int = 4             # keyframe view ring (matcher.cpp:397-402)
    point_evict_retain: int = 40   # capacity-pressure point eviction (no
                                   # ref analog NEEDED: the reference's
                                   # point vector grows unboundedly,
                                   # localmap.h:317-319 — eviction is the
                                   # fixed table's equivalent of "never
                                   # full"). When a keyframe's seeds would
                                   # overflow max_points, dead slots
                                   # (never-cleared MISMATCHED/BAD_LOCATION
                                   # + slam-dead) then LRU-stale slots
                                   # (newest obs older than this many
                                   # frames) are reclaimed; bit-identical
                                   # below capacity. Must exceed the widest
                                   # presented window (solve_xslow[1]=32).
                                   # 0 disables. Without it the bench map
                                   # saturates mid-scan and collapses into
                                   # a terminal keyframe storm (seed 1:
                                   # frame 111, PERF.md finding 41)
    uncertainty_confident: float = 100.0  # matcher.cpp:228,234; slam.cpp:347
    find_fail_backoff: int = 4     # straggler rate limit (no ref analog —
                                   # the reference re-attempts every stored
                                   # view of every failing feature every
                                   # frame, matcher.cpp:221-248, which is
                                   # what 1 reproduces; tools/parity.py pins
                                   # 1 for the golden fixture). k>1: a
                                   # feature whose attempts ALL failed last
                                   # frame only re-attempts every k-th frame
                                   # (staggered by slot), cutting the
                                   # exploration-time retry ladder ~k-fold;
                                   # recovering features re-match <= k-1
                                   # frames late. 4 measured 31.2->36.4 fps
                                   # on the live-exploration bench with
                                   # BETTER accuracy (ATE 3.3%->1.0%,
                                   # tools/profile_scan.py)

    roundtrip_levels: int = 0      # backward-consistency cascade cap (0 =
                                   # full forward budget, the reference's
                                   # exact TrackFeature-both-ways,
                                   # matcher.cpp:173-206). Capping looked
                                   # attractive — the backward pass starts
                                   # at the exact answer — but both
                                   # directions start there; it is the
                                   # COARSE levels' 4x/16x-wider context
                                   # that pulls a wrong match's backward
                                   # track away and fails the 0.3 px gate.
                                   # cap=1 measured 7-12%% trajectory ATE
                                   # (vs 1%% full): the cheap gate accepts
                                   # marginal matches that poison BA. Keep
                                   # 0 unless re-measured
    retry_mode: str = "ladder"     # "ladder": the reference's full walk —
                                   # every (stored view x level budget)
                                   # attempt of every failing lane, every
                                   # frame (matcher.cpp:221-269) as 2V
                                   # cond-guarded sweeps. "cycle": ONE
                                   # first-choice sweep (newest view,
                                   # uncertainty levels) + retry_sweeps
                                   # sweeps where each still-failing lane
                                   # tries the attempt its fail counter
                                   # cycles to — same attempt set, spread
                                   # over consecutive due frames.
                                   # MEASURED (live-exploration bench):
                                   # with find_fail_backoff=4 the ladder's
                                   # extra sweeps are usually empty (cond-
                                   # skipped) so cycle saves little, and
                                   # its slower straggler recovery either
                                   # decays match counts into a keyframe
                                   # storm (no escalation) or delays
                                   # keyframes the map's accuracy wants
                                   # (with escalation): 28.3ms/1.5%% ATE
                                   # ladder vs 34.8/1.0 cycle vs 29.2/4.3
                                   # cycle+escalation. Ladder stays the
                                   # default; cycle remains for workloads
                                   # with expensive per-sweep costs
    retry_sweeps: int = 1          # extra per-frame attempts in cycle mode
    adaptive_fwd_px: float = 0.0   # SHARP-lane shallow tracking: a lane
                                   # that matched last frame within this
                                   # many px of its projection prediction
                                   # runs its next first-choice attempt at
                                   # ONE pyramid level both ways; failures
                                   # fall through to the same frame's
                                   # full-budget retry pass. 0 disables
                                   # (reference budgets). MEASURED OFF:
                                   # at 2.0 the bench gained no speed
                                   # (bucket savings offset by retry-pass
                                   # fallthrough + map churn) and ATE went
                                   # 1.0 -> 3.9%% — the 1-level backward
                                   # gate admits marginal matches, the
                                   # same failure mode as
                                   # roundtrip_levels=1
    bwd_window_cache: bool = True  # cache per-(lane, view, level) search
                                   # windows at keyframe time (a stored
                                   # view's match locations never change)
                                   # so the backward pass reads its
                                   # windows from a flat table instead of
                                   # slicing the view pyramid per sweep
                                   # (~1.5 ms/frame). The cascade can
                                   # drift past the cached margin for
                                   # already-bad tracks — clamped + masked
                                   # like bwd_ref_from_window.
                                   # tools/parity.py pins False
    bwd_ref_from_window: bool = True  # sample the backward-consistency
                                   # pass's reference patches from the
                                   # forward pass's own search windows
                                   # (pure math) instead of re-extracting
                                   # them from the new pyramid (~1.4 us
                                   # per plane-slice row; ~1.6 ms/frame
                                   # trace-measured). Identical values
                                   # whenever the patch support lies in
                                   # the forward window — support that
                                   # drifted past the margin is masked
                                   # invalid instead (those tracks were
                                   # headed for a roundtrip reject).
                                   # tools/parity.py pins False
    find_fail_backoff_deep: int = 4  # extra rate limit for the 6-level
                                   # retry passes (matcher.cpp:248): a
                                   # straggler's deep retries are its
                                   # costliest attempts (6 levels x both
                                   # directions x every stored view) and
                                   # its least likely to succeed; they
                                   # re-attempt every k-th frame (slot-
                                   # staggered) while the shallow passes
                                   # follow find_fail_backoff. 1 =
                                   # reference cadence (tools/parity.py).
                                   # MEASURED: 8 saved ~0.2 ms but ATE
                                   # 0.9 -> 2.0%% — slower 6-level seed
                                   # recovery starves fresh landmarks;
                                   # 4 (= the shallow cadence) is neutral
    find_fail_give_up: int = 16    # drop a feature lane after this many
                                   # consecutive all-attempts-failed due
                                   # frames (0 = never, the reference
                                   # retries forever, matcher.cpp:221-248).
                                   # A lane that failed every stored view
                                   # 16 times across 64 frames (backoff 4)
                                   # has left the field of view; its map
                                   # point stays, only the tracker slot
                                   # frees. Persistent stragglers were
                                   # ~2 ms/frame of retry sweeps while
                                   # exploring (trace-measured)
    retry_escalate_margin: int = 16  # cycle mode: if the cycled retries
                                   # still leave fewer than min_matches +
                                   # margin lanes matched, fall back to
                                   # the FULL ladder walk for this frame
                                   # (one lax.cond — compiled once, only
                                   # executed on decaying frames). One
                                   # retry/frame alone lets match counts
                                   # decay through the keyframe threshold
                                   # while exploring (measured: keyframe
                                   # every other frame, 35/64); the walk
                                   # is far cheaper than the keyframe +
                                   # map churn it prevents. -1 disables

    # ---- map maintenance (localmap.cpp) ----
    error_threshold: float = 5.0       # Clean threshold (main.cpp:555)
    clean_maxerr_div: float = 4.0      # worst-first bar maxerr/4 (localmap.cpp:366)
    bad_feature_avg_err: float = 1.5   # localmap.cpp:352
    bad_feature_min_obs: int = 4       # localmap.cpp:352
    min_baseline_mm: float = 50.0      # NO_BASELINE clear distance (localmap.cpp:75)
    epipolar_threshold: float = 0.0015  # localmap.cpp:260
    epipolar_hard_mult: float = 100.0   # disable at 100x threshold (localmap.cpp:267)
    epipolar_mismatch_obs: int = 8      # localmap.cpp:268
    close_point_z: float = 1.0          # BAD_LOCATION cutoff (localmap.cpp:329)
    not_moving_d2: float = 5.0          # idle-frame removal (localmap.cpp:178)
    homogeneous_w_min: float = 1e-6     # w clamp (localmap.cpp:303-306)

    # ---- bundle adjustment (slam.cpp, main.cpp:580-592) ----
    solve_fast: tuple[int, int] = (2, 5)    # (num_to_solve, num_to_present)
    solve_slow: tuple[int, int] = (10, 20)
    slow_every: int = 5                # main.cpp:587
    slow_first_n: int = 10
    ba_range: float = 2.0              # CauchyLoss scale (main.cpp:582,593)
    ba_max_iters: int = 50             # ref allows 1000 (slam.cpp:493); GN needs far fewer
    ba_iters_fast: int = 20            # per-frame window (2,5). LM exits on
                                       # ftol/stall, so converged windows
                                       # stop early anyway; the round-1 caps
                                       # (8/15) silently UNDER-CONVERGED the
                                       # weakly-observable forward motion —
                                       # 8.7% -> 0.9% trajectory ATE at
                                       # 20/30 (the "windowed drift" wasn't
                                       # window myopia at all)
    ba_iters_slow: int = 30            # periodic window (10,20)
    window_obs_fast: int = 768         # obs tail slice for the fast window
                                       # (5 presented frames x <=120 obs
                                       # plus margin; the einsum O axis
                                       # bills every row each LM iter)
    ba_compact_obs_fast: int = 512     # compact participating rows to the
                                       # front of the fast window (one
                                       # stable argsort per solve) and
                                       # truncate: each of the ~20 LM
                                       # iterations bills this many rows
                                       # instead of window_obs_fast. The
                                       # (2,5) window carries ~290 active
                                       # rows (~58 matches x 5 frames);
                                       # excluded masked rows contributed
                                       # zero. Overflow past the cap is
                                       # counted in obs_dropped. 0 = off
                                       # (tools/parity.py pins 0: fp
                                       # summation order changes)
    ba_compact_obs_slow: int = 0       # same for the slow (10,20) window —
                                       # OFF by default: measured on the
                                       # rotation-heavy parity sequence
                                       # (test env, RMSE gate metric), slow
                                       # compaction's fp-order shift lands
                                       # a worse cadence draw (1.35% fast-
                                       # only -> 3.00% both-on, vs 1.76%
                                       # all-off), and its cost only
                                       # amortizes 1/slow_every per frame.
                                       # Re-evaluate on-chip via
                                       # profile_scan set: variants.
    ba_free_points_fast: int = 512     # free-landmark slot capacity for the
                                       # fast window's assembly tensors
                                       # (ops/ba.py max_free_points): the
                                       # (2,5) window plus freshly-seeded
                                       # uncertain points touch ~150-400
                                       # free points, but uncompacted
                                       # assembly bills all max_points
                                       # every LM iteration. Overflow
                                       # solves as const (graceful). 0
                                       # disables
    ba_free_points_slow: int = 768     # same for the slow (10,20) window;
                                       # it can free most of the map late
                                       # in a run, but compaction priority
                                       # is newest-first so overflow
                                       # demotes the oldest, already-
                                       # converged landmarks to const for
                                       # that solve
    ba_ftol: float = 1e-6              # function_tolerance. The reference
                                       # passes 1e-7 to Ceres (slam.cpp:494)
                                       # under f64; in f32 a relative cost
                                       # change of 1e-7 is BELOW machine
                                       # epsilon (1.2e-7), so the exit can
                                       # never fire and every window burns
                                       # its full iteration cap (trace:
                                       # fast window = 20/20 iters every
                                       # frame). 1e-6 is the tightest
                                       # f32-representable band (3e-6
                                       # measured faster BA but ATE 1.0 ->
                                       # 1.8%% via keyframe-cadence shift)
    ba_ftol_fine: float = 1e-9         # slam.cpp:498 (final --final-ba
                                       # polish; kept reference-exact, the
                                       # stall/xtol exits bound it)
    frame_dist_weight: float = 0.3     # FrameDistance residual weight. The
                                       # reference uses 0.1 (slam.cpp:100),
                                       # but this prior is the ONLY scale
                                       # anchor once frames 0/1 freeze
                                       # (the rig's 150 mm stereo baseline
                                       # is physically rigid), and at 0.1
                                       # the trajectory's scale drifts
                                       # 2-5% per segment on the bench
                                       # sweep. 0.3 pins the per-segment
                                       # scale fits to ~1.00 at zero
                                       # per-frame cost (CPU A/B: ATE
                                       # 15.4 -> 9.6 mm; w >= 0.5 risks
                                       # keyframe-cadence storms and
                                       # w >= 1.5 over-constrains, biasing
                                       # scale the other way).
                                       # tools/parity.py pins 0.1
    frame_dist_loss: float = 15.0      # CauchyLoss(15) (slam.cpp:404)
    camera_loss: float = 5.0           # CauchyLoss(5) on intrinsics (slam.cpp:463)
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 0.5
    lm_lambda_min: float = 1e-10       # lambda floor (see ops/ba.BAConfig:
                                       # tames gain-ratio near-GN steps in
                                       # low-parallax regimes)
    lm_policy: str = "marquardt"       # "classic" fixed up/down factors |
                                       # "marquardt" Ceres's gain-ratio
                                       # damping (what the reference's
                                       # Ceres solve actually runs,
                                       # slam.cpp:482-521). The fixed
                                       # policy thrashes on the bench fast
                                       # window (~15 of 20 LM iterations
                                       # are rejected steps, trace r4);
                                       # gain-ratio damping removed the
                                       # keyframe storms outright (27 ->
                                       # 9 keyframes on the bench seed)
                                       # and is the single largest ATE
                                       # lever measured in round 4
                                       # (PERF.md finding 33)
    cheirality_eps: float = 0.001      # project.h:27
    window_obs: int = 3072             # obs-table tail slice for window BA
                                       # (20 presented frames x <=120 obs
                                       # plus margin)
                                       # (covers >= 20 frames x 120 obs)
    reproject_window: int = 3072       # maintenance reproject tail rows
                                       # (0 = full table, the reference's
                                       # exact ReprojectMap; older rows'
                                       # errors only change when their
                                       # point moves under a free frame)
    polish_at: int = 20                # one-time early-trajectory polish:
                                       # at this frame index run a
                                       # SolveAllFrames-style wide solve
                                       # (slam.cpp:447-480 exists for
                                       # exactly this) freeing every frame
                                       # except the 0/1 gauge anchor. The
                                       # sliding windows freeze the early
                                       # chain before the map has enough
                                       # baseline to pin its scale and
                                       # heading (PERF.md finding 21:
                                       # drifting 2-3% per-segment scale +
                                       # 1.67 deg early-locked rotation);
                                       # re-solving the early frames once,
                                       # with all later evidence present,
                                       # repairs both. HOST-triggered:
                                       # drivers call pipeline.maybe_polish
                                       # between frames (it fires once, so
                                       # compiling it into the step's
                                       # lax.cond billed every frame ~14%
                                       # for the cond-boundary copies).
                                       # 0 = off
    polish_solve: int = 0              # frames freed by the polish
                                       # (0 -> polish_at - 1: everything
                                       # but the frame-0/1 anchor)
    polish2_at: int = 0                # second, deeper polish trigger: a
                                       # one-time full re-solve at this
                                       # frame (frees polish2_at-1 frames).
                                       # Rationale: on hard texture draws
                                       # the frame-20 polish repairs with
                                       # WEAK evidence (few matches early)
                                       # and the trajectory error plateaus
                                       # by frame ~32 (probe_seed1 accrual
                                       # curve: 13 -> 25 mm over frames
                                       # 0-32, flat after); a second polish
                                       # after the chain has real baseline
                                       # re-anchors the early frames while
                                       # their obs rows still exist. 0=off
    ba_iters_polish: int = 40          # LM budget for the polish solve
    solve_xslow: tuple[int, int] = (16, 32)  # third BA tier (no ref analog;
                                       # the rolling form of the polish):
                                       # every xslow_every frames, free the
                                       # newest solve_xslow[0] frames
                                       # against solve_xslow[1] presented —
                                       # wide enough to reach back past
                                       # where the (10,20) window froze the
                                       # chain, repairing scale/heading
                                       # drift while the anchor frames are
                                       # still presented. (0,0) = off
    xslow_every: int = 24              # cadence of the xslow tier
    ba_iters_xslow: int = 30           # LM budget for the xslow tier
    normalize_canary_rows: int = 64    # rows of the post-normalize
                                       # invariance canary: the reference
                                       # CHECKs reprojection-error
                                       # invariance across Normalize EVERY
                                       # frame to +-0.1 (main.cpp:602-605);
                                       # the rebuild recomputes only on
                                       # slow/touched frames, so this
                                       # re-projects the newest K obs rows
                                       # every frame and surfaces the max
                                       # per-row drift as a metric
                                       # (normalize_canary_px). 0 = off

    # ---- optional behaviors (declared but unwired in the reference) ----
    mid_frame_resolve: bool = False    # matches<40 -> epipolar pose
                                       # re-solve + re-match before
                                       # keyframing (matcher.cpp:338-346;
                                       # dead in the reference because
                                       # SolveFramePose returns false,
                                       # slam.cpp:182 — this enables the
                                       # INTENDED behavior)
    motion_model: str = "copy"         # "copy" (ref, main.cpp:550-552) |
                                       # "constant_velocity" (the intended
                                       # EstimateMotion, localmap.h:300)
    drop_idle_frames: bool = False     # CheckNotMoving (localmap.cpp:173-187,
                                       # never called by main.cpp)
    clean_duplicates: bool = False     # CleanDuplicates (matcher.cpp:274-288,
                                       # call commented out at :348)

    # ---- planner (planner.cpp) ----
    turning_radius: float = 2.0        # planner.cpp:24
    path_types: int = 18               # planner.cpp:25
    interp_step: float = 0.1           # planner_test / onMouse

    # ---- fixed capacities for the SoA state (TPU-native; no ref analog) ----
    max_frames: int = 512
    max_points: int = 1024
    max_obs: int = 16384
    max_obs_per_point: int = 64
    max_features: int = 256            # live matcher feature slots (the ref
                                       # tops out ~120 corners + carryover)

    # ---- numerics ----
    dtype: str = "float32"

    @property
    def window(self) -> int:
        return self.patch_size


# The production defaults above deviate from reference tracking semantics
# where a deviation measured strictly better on the TPU (each knob's
# docstring carries the numbers). These are the pins that undo every
# deviation — matcher.cpp:221-269's exact retry walk, symmetric backward
# cascade, fresh per-sweep window gathers. tools/parity.py regenerates its
# golden fixture under these, and reference_exact() keeps the two lists
# from drifting apart (ADVICE r2).
REFERENCE_EXACT_KW = dict(
    find_fail_backoff=1,
    find_fail_backoff_deep=1,
    find_fail_give_up=0,
    retry_mode="ladder",
    roundtrip_levels=0,
    bwd_ref_from_window=False,
    bwd_window_cache=False,
    adaptive_fwd_px=0.0,
    track_iters_coarse=0,
    seed_depth_adaptive=False,
    frame_dist_weight=0.1,
    ba_compact_obs_fast=0,
    ba_compact_obs_slow=0,
    # the reference's main loop never calls SolveAllFrames (slam.cpp:447
    # exists but main.cpp:587-597 only runs the (2,5)/(10,20) windows) —
    # the one-time polish and the rolling xslow tier are production
    # deviations. lm_policy IS pinned even though gain-ratio damping is
    # what the reference's Ceres runs: under these pins (backoff=1,
    # frame_dist 0.1) the classic policy measured 1.8% vs marquardt's
    # 5.4% on the rotation_heavy sequence — the pin freezes the goldens'
    # semantics to the better-measured solver behavior for that regime.
    polish_at=0,
    solve_xslow=(0, 0),
    lm_policy="classic",
)


def reference_exact(**overrides) -> SlamConfig:
    """A SlamConfig with reference-exact tracking semantics (every measured
    production deviation undone). ``overrides`` lets callers keep their
    capacities/resolution while pinning semantics."""
    kw = dict(REFERENCE_EXACT_KW)
    kw.update(overrides)
    return SlamConfig(**kw)


DEFAULT = SlamConfig()

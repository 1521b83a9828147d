"""Typed configuration of the front end and bundle adjustment (PyTorch port).

A copy of the dataclasses of the JAX package's `config.py` (front end,
RANSAC, BA, pose graph, loop detection and the SLAM wiring), with the same
fields and defaults, so that both packages run the same configuration.
Frozen dataclasses stay hashable. The JAX package's
`BAConfig.dense_assemble_bf16` is not carried (see `convert.ba_config_from`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class FrontendConfig:
    """Feature detection / description / matching knobs.

    Reference: ref `src/params.h:9-15` and hard-coded arguments at ref
    `src/visual_odometer.cpp:234-242` (goodFeaturesToTrack + cornerSubPix).
    """

    # Max corners per image. Reference uses 1000 (ref src/params.h:9); the
    # JAX package pads to 1024 so the match tiles are whole; kept for parity.
    num_features: int = 1024
    # Shi-Tomasi quality level relative to the strongest corner response
    # (ref src/visual_odometer.cpp:234, goodFeaturesToTrack arg 4 = 0.01).
    quality_level: float = 0.01
    # Minimum distance between detected corners, enforced as an NMS radius
    # (ref src/visual_odometer.cpp:234, arg 5 = 10). The reference greedily
    # suppresses in score order; we use grid NMS which is equivalent in
    # coverage and fully parallel.
    min_distance: int = 10
    # Structure-tensor window (ref src/visual_odometer.cpp:234, blockSize=5).
    block_size: int = 5
    # Subpixel refinement: the reference runs iterative cornerSubPix with a
    # 5x5 window for up to 40 iters (ref src/visual_odometer.cpp:238-242); we
    # use a single closed-form quadratic fit on the corner response, which is
    # branch-free and batched.
    subpix: bool = True
    # ORB descriptor geometry: 256 binary tests in a 31x31 patch, orientation
    # from the intensity centroid of a radius-15 disc (standard ORB).
    patch_size: int = 31
    orientation_radius: int = 15
    # Rotation-steered descriptors. Default FALSE = upright BRIEF, which is
    # what the reference actually computes: cv::ORB::compute on externally
    # detected corners never fills kp.angle, so its pattern is unrotated
    # (ref src/visual_odometer.cpp:256-259). Upright also MEASURES better
    # on realistic scenes (tests/test_realism.py) — the intensity-centroid
    # angle jitters several degrees between views, flipping pattern bits.
    # Enable for workloads with genuine in-plane camera roll.
    oriented: bool = False
    # Gaussian-ish pre-smoothing used before sampling BRIEF tests.
    smoothing_ksize: int = 7
    # Matching: absolute Hamming distance gate and Lowe ratio
    # (ref src/params.h:12,15; applied at ref src/visual_odometer.cpp:275-276).
    match_max_distance: float = 30.0
    match_ratio: float = 0.5
    # Minimum stereo matches to consider a frame trackable
    # (ref src/visual_odometer.cpp:117).
    min_stereo_matches: int = 5


@dataclass(frozen=True)
class RansacConfig:
    """Batched RANSAC rigid-transform solver.

    The reference delegates to an absent git submodule (`ransac_solver`,
    interface reconstructed in SURVEY.md C8; options set at ref
    `src/visual_odometer.cpp:21-27` from ref `src/params.h:18-27`).
    Our solver evaluates every hypothesis in parallel, so "early
    termination" does not exist; the hypothesis count is static.
    """

    # Reference runs up to 100 sequential iterations (ref src/params.h:27);
    # we evaluate 128 hypotheses in one batched pass.
    num_hypotheses: int = 128
    # Consensus ratio kept for parity (ref src/params.h:24); only meaningful
    # for the success heuristic since all hypotheses are evaluated anyway.
    consensus_ratio: float = 0.8
    # Re-fit the model on all inliers of the winning hypothesis
    # (ref src/params.h:18 sets false).
    final_model_fitting: bool = False
    # Max stereo-reprojection error (px, max over the 4 residual components)
    # for a pair to count as an inlier. The reference value lives in the
    # absent submodule; 3 px is tuned on synthetic + KITTI data.
    inlier_threshold_px: float = 3.0
    # Minimum observation pairs to attempt a solve
    # (ref src/visual_odometer.cpp:100).
    min_pairs: int = 10
    # Minimum inliers for the winning model to be accepted (guards against
    # degenerate 3-point-only consensus; no analogue in the reference).
    min_inliers: int = 6


@dataclass(frozen=True)
class BAConfig:
    """Bundle adjustment (Levenberg-Marquardt + Schur complement).

    Reference: Ceres options at ref `src/bundle_adjuster.cpp:13-36` and
    constants at ref `src/params.h:34-47`.
    """

    # LM iterations (ref src/params.h:34).
    max_iterations: int = 50
    # Huber loss scale (ref src/bundle_adjuster.cpp:100, HuberLoss(1.0)).
    huber_delta: float = 1.0
    # Landmark coordinate box bounds (ref src/params.h:44-47), applied as a
    # clamp after each accepted LM step.
    point_bound: float = 10000.0
    # PCG on the reduced camera (Schur) system.
    cg_iterations: int = 100
    cg_tol: float = 1e-6
    # LM damping schedule.
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 0.5
    lm_lambda_min: float = 1e-10
    lm_lambda_max: float = 1e8
    # Relative cost-decrease tolerance for early stop (the reference sets
    # Ceres tolerances to 1e-16, i.e. effectively runs to the iteration cap;
    # ref src/bundle_adjuster.cpp:35-36).
    function_tolerance: float = 1e-9
    # Wall-clock cap per solve, the reference's Ceres max_solver_time
    # (1 s, ref src/params.h:41). 0 disables. Only enforced on the chunked
    # large-solve path (backend.ba.BundleAdjuster); small windowed solves
    # run as one unchunked solve.
    max_solve_seconds: float = 0.0
    # Dense-Schur fast path (backend/schur_dense.py): used when the window
    # has at most this many cameras AND the point-grouped slot count
    # (P_pad * max_track_len) fits; larger/global problems stay matrix-free.
    dense_schur_max_cams: int = 512
    dense_schur_max_slots: int = 4_194_304
    # BANDED Schur assembly (schur_dense.band_plan/assemble_schur_banded):
    # when every point chunk's camera span fits a band of width
    # <= banded_max_width, the one-hot expansion and reduced-system
    # contraction run at band width B instead of full C — (B/C)^2 of the
    # dense flops. Feasibility is proven per problem on the host; problems
    # with loop-distant observations automatically fall back to the dense
    # expansion. Exact same math when feasible.
    banded_schur: bool = True
    banded_max_width: int = 128


@dataclass(frozen=True)
class PoseGraphConfig:
    """SE(3) pose-graph Gauss-Newton.

    Reference: g2o setup at ref `src/pose_graph_optimizer.cpp:14-27`, 10
    iterations at ref `src/pose_graph_optimizer.cpp:69`.
    """

    iterations: int = 10
    # Information matrix: identity with the translation block scaled to 0.01
    # (ref src/pose_graph_optimizer.cpp:23-26; g2o EdgeSE3 orders error as
    # [translation, rotation]).
    info_translation: float = 0.01
    info_rotation: float = 1.0
    huber_delta: float = 1.0
    # Gauss-Newton damping for robustness (reference uses g2o Levenberg).
    damping: float = 1e-6
    cg_iterations: int = 200
    cg_tol: float = 1e-8
    # Wall cap for the global BA a LIVE (mid-run, loop-exit) pose-graph
    # solve triggers — the reference's Ceres max_solver_time_in_seconds
    # (1 s, ref src/params.h:41 via pose_graph_optimizer.cpp:95): a loop
    # closure must never blank more than ~1 s of the live loop; the solve
    # returns best-so-far. End-of-sequence solves are uncapped here (they
    # honor BAConfig.max_solve_seconds instead).
    live_ba_max_seconds: float = 1.0
    # Frame extent of that LIVE post-closure refinement. The reference
    # global-BAs the whole map mid-run under the same 1 s Ceres cap — at
    # deep-sequence scale that buys roughly one LM iteration while costing
    # a full giant-problem build (the r4 endurance trace measured a
    # multi-minute stall in exactly this call). Bounding the live solve to
    # the trailing window keeps the stall within the cap at ANY sequence
    # length; the full-map polish still runs at finish() (ref
    # slam.cpp:152-156). 0 = whole map (reference cadence). 64 keeps the
    # live refinement inside the dense-Schur gate EVEN when feature tracks
    # span the entire window (K = pow2(track length) multiplies the slot
    # count; at 64 frames P_pad*K stays under dense_schur_max_slots).
    live_ba_window_frames: int = 64
    # Minimum frame spacing between LIVE polish BAs: sustained revisits
    # make the Bayes filter exit/re-enter loops every few dozen frames
    # (29 episodes over the 1,200-frame canyon), and consecutive polishes
    # over the same live_ba_window are redundant by construction — the
    # pose graph has already applied each closure's correction, and
    # finish() runs the full-depth solve. 0 = polish after every closure
    # (reference cadence, ref pose_graph_optimizer.cpp:95).
    live_polish_min_spacing_frames: int = 32
    # Candidate loop edges measured per LIVE closure (most recent kept).
    # A long revisit queues one candidate per frame (375 in the r4
    # endurance drive); they are massively redundant — consecutive frames
    # of the same revisit — and each one costs matcher+RANSAC work inside
    # the stall. The reference measures every queued candidate serially
    # (ref pose_graph_optimizer.cpp:175-217) and would stall far longer.
    # 0 = measure all (reference cadence). Final (finish) solves always
    # measure everything still queued.
    live_max_edges: int = 128


@dataclass(frozen=True)
class LoopConfig:
    """Bag-of-words place recognition + Bayesian loop filter.

    Reference: ref `src/params.h:54-81` and ref `src/loop_detector.cpp`.
    """

    query_size: int = 4              # ref src/params.h:54
    adjacent_frame_thresh: int = 5   # ref src/params.h:57
    distant_frame_thresh: int = 50   # ref src/params.h:60
    score_window: int = 5            # ref src/params.h:63
    match_probability_thresh: float = 0.5   # ref src/params.h:66
    is_loop_thresh: float = 0.9      # ref src/params.h:69
    not_loop_thresh: float = 0.1     # ref src/params.h:72
    decay_rate: float = 0.75         # ref src/params.h:75
    min_loop_probability: float = 0.005  # ref src/params.h:78
    max_loop_probability: float = 0.995  # ref src/params.h:81
    # Score-likelihood prior. The reference stubs ScoreProbability() to 0.5
    # (ref src/loop_detector.cpp:167-170); we keep that behavior by default
    # and document it as a quirk.
    score_probability: float = 0.5
    # Flat vocabulary size (replaces the DBoW2 k^d tree: the reference uses
    # branching 9 / depth 3 = 729 leaves, ref src/loop_detector.cpp:9-10).
    # Flat nearest-word assignment is one top-1 Hamming search (the
    # hamming_top2 kernel, the words as its train set).
    vocab_words: int = 1024
    vocab_iterations: int = 8
    # Capacity of the BoW database (frames), grown by re-allocation.
    database_capacity: int = 8192


@dataclass(frozen=True)
class SlamConfig:
    """Top-level pipeline wiring (the gflags tier, ref src/slam.cpp:31-35)."""

    frontend: FrontendConfig = FrontendConfig()
    ransac: RansacConfig = RansacConfig()
    ba: BAConfig = BAConfig()
    pose_graph: PoseGraphConfig = PoseGraphConfig()
    loop: LoopConfig = LoopConfig()
    # Sliding-window BA cadence: every `refine_interval` frames optimize the
    # last 2*refine_interval frames (ref src/slam.cpp:34,126-129).
    refine_interval: int = 10
    # Per-frame single-pose BA (landmark-only refine since the lone pose is
    # held fixed; ref src/slam.cpp:123 + src/bundle_adjuster.cpp:113).
    per_frame_ba: bool = True
    # Frames per device dispatch in the live loop (SlamSystem.process_batch):
    # 1 = the reference cadence (one Track/BA/Query per frame); >1 batches
    # K frames into one front-end chain + one BoW scoring + one BA solve.
    batch_frames: int = 1
    # LM iteration budget for the live-loop (batched) BA solves. The
    # reference effectively runs min(50 iterations, 1 s wall) per solve
    # (ref src/params.h:34,41); windowed refinement converges in far fewer
    # iterations, and the live loop's latency budget is the binding
    # constraint. finish()/global BA keep the full 50.
    live_ba_iterations: int = 12
    output_suffix: str = "slam"

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

"""Typed configuration of the front end and bundle adjustment (PyTorch port).

A copy of the front-end, RANSAC and BA dataclasses of the JAX package's
`config.py`, with the same fields and defaults, so that both packages run
the same configuration. Frozen dataclasses stay hashable. The pose-graph,
loop and SLAM configurations follow with the slices that use them.
"""

from __future__ import annotations

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

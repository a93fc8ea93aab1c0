#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mpsfm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Builds the hand-written kernels from mpsfm_tpu_torch/csrc/*.cu with
   nvcc for sm_90a (one nvcc per source, all started together) into
   mpsfm_tpu_torch/_build/, and prints the build time and what ptxas
   reports of each kernel (registers, spills).
2. Holds each kernel against its plain torch version on the card:
   K1 (cholesky.cu) on random SPD matrices at K = 6, 390, 384 and 1024,
   strongly and less diagonally dominant, and on two with a zeroed row
   and column (a clamped pivot), timed beside its plain version and the
   library call at 384 and 1024; K1 with many right-hand sides
   (cholesky_many.cu) at K = 384, N = 24 576 (the covariances' solve),
   K = 390, N = 1000 (ragged blocks and column tile), K = 3072, N = 1000
   (the JAX package's largest dense covariance) and K = 33, N = 24 577
   (ragged, 4-byte staging), timed beside its plain version and the library
   call, with its three kernels (factorization, tile packing, substitution)
   timed apart; K2 (bini.cu) as the PCG core of
   the main path's first IRLS round (iteration counts within 1,
   bit-identical from run to run, and at B = 16 as two lane groups; a
   cooperative launch larger than the card refused) and as the
   fixed-budget solve, at B = 8 images of 290×387, timed per solve, per
   CG iteration and against the design's floor (its two lane barriers
   per iteration with almost no arithmetic), its checks shown to fail
   the plain version turned into a kernel with a stale or dropped halo
   at one CTA's seams; K3 (bini_diag.cu), the deflated PCG of diag(H⁻¹) on
   thread-block clusters, at 8 images of 145×193 with 2048 queries each
   and 16 iterations and at 2 images of 193×193, of 290×387 and of 400×600
   with 64 queries each (grids above one block's shared memory; 400×600
   keeps its bands in global memory), one launch each, bit-identical from
   run to run, the cluster shape (C CTAs, R right-hand sides) printed, the
   global mode equal bit for bit to the shared-memory mode at the main grid,
   timed beside its plain version at the main shapes and at 400×600, and
   its check shown to fail a kernel without the deflation's projection and
   one that drops p's halo row at a band edge.
3. Drives the main path at full size, once to warm up and once measured
   with every launch count set to 0 just before: the mapper's refinement
   step in the order of the JAX package's Mapper (calculate_point_covs,
   then Optimizer.ba_fused with the int_covs chain) — point covariances of
   the bench bundle (64 cameras × 8192 points), BiNI energy gate +
   IRLS/PCG solve of 8 depth maps (290×387, the main path's BiNI
   parameters; anchors priced by those covariances), the fresh depth
   downscaled to 145×193 and diag(H⁻¹) there at 2048 keypoints per image
   (16 deflated PCG iterations), the keypoints' depth variances updated
   from it, the depth-consistency check of each refined map (the query)
   against its 5 nearest lanes (the mapper's local bundle; depth exp(z),
   the prior variance grid ÷ 3.33², the bundle's poses), depth rows with
   those variances sampled from the refined maps, then 20 LM iterations
   of the dense LM-Schur BA. It checks finite, symmetric covariances with
   a positive diagonal whose depth variance grows with depth, finite
   positive variances that moved on the changed lanes, depth-consistency
   counts of every pair with valid pixels and equal to the CPU's on the
   same depth (or differing only at pixels within 1e-5 of a boundary, the
   scores within 0.02), a lower cost, ≥ 3 accepted steps, depth rows with
   weight, depth maps closer to the ground truth than their priors, and
   that every kernel entry point was launched.
4. Runs the same chain at a small size on the card and on the CPU (plain
   versions) and compares the results, with the depth std floored as on
   the main path and unfloored (where K3's variances reach the depth rows
   and must change sigma²); and compares the point covariances' scatter
   path (no per-(point, camera) tables) card vs CPU.
5. The depth-consistency check on a consistent scene at 290×387: one
   world plane rendered into 6 of the bundle's cameras scores below the
   mapper's threshold 0.15, and above it once one reference's depth is
   shifted by 1.5.
6. The estimators, with the mapper's budget of 512 hypotheses: two-view
   verification of the 66 pairs of 12 of the bundle's cameras (2048
   matches each) and PnP at 4096 matches on points in general position and
   on one plane (1 px noise, 30% outliers), timed after a warm-up, held
   against the truth and against the CPU with the same samples; the
   library solvers behind two-view verification (batched QR and eigh)
   timed apart.
7. The scene's host state (slice 5a): a Reconstruction of the bundle at
   the main path's refined poses and points (64 images of one 640×480
   camera, 8192 keypoints each, 8192 points each seen by every image:
   524 288 observations in the native track store, built with g++), its
   passes timed on the host clock (adding the points, the observation
   table, triangulation angles, filter_points3D at 4 px and 1.5 deg, the
   local bundle of one image, deregistering one image, deleting and
   re-adding 10% of the points, normalize) with the pool's invariants
   checked after each; the native store against the plain one
   (PyTrackStore) under one op sequence on 12 images; geometric
   verification of the 66 pairs of 12 images (2048 matches each, 30%
   outliers) through Correspondences.populate on the card, timed after a
   warm-up, held against the truth (every pair CALIBRATED, the median
   pair within 1 deg and 90% of the true inliers) and against populate on
   the CPU with the same samples, its correspondence graph to the inlier
   matches; and the point covariances' store (LazyCovDict) with the main
   path's covariances on the card.
8. The refinement step driven from the scene (slices 5b and the front of
   6a): a Reconstruction of the bundle (64 images, 8192 points each seen
   by every image) with ImagePriors on 8 images at 290×387 (a depth prior
   fitted to each image's points with a scale error and noise, the plane's
   normals; the main path's conf), run through the port's entry points in
   the order of the JAX package's Mapper.adjust_bundle with int_covs:
   Optimizer.calculate_point_covs (K1 many), a global step
   (integrate_bundle_deferred over the 8 lanes (K2), finalize_integration,
   int_covs_bundle_batched on the changed lanes (K3, 8192 keypoints each),
   Optimizer.ba_fused with update_trunc (K1)), a local step of one image
   (integrate_bundle_deferred, int_covs_bundle_deferred, ba_fused with the
   chained variances), then optimize_prior_shiftscale, Depth.rescale and
   refine_3d_points; once to warm up, then on a fresh scene with the launch
   counts set to 0, each entry point's wall time printed (build_ba_data's
   host passes apart) and K3 timed at int_covs_bundle_batched's shapes.
   Held: finite, symmetric covariances with a positive diagonal, parked
   with a slot for every point (the anchors' codes then ≥ 0); each BA's
   cost below its start with an accepted step; poses and points written
   back; changed lanes device-resident until read and closer to the
   points' true depths than their priors; uncertainty_update finite,
   positive and moved on the changed lanes; a finite truncation
   multiplier; each of K1, K1 many, K2 and K3 launched. The same phase at
   the small size on the card and on the CPU agrees (z, covariances,
   uncertainty_update, costs; poses, points and the truncation multiplier
   with LM iterations that end before the rel_tol latch).
9. Mapping a scene (slice 6b): MpsfmMapper on the card, with the main
   path's mapper conf (ba.max_iters 20, int_covs and the depth-consistency
   check on, 512 hypotheses a registration), over 12 images of a 640×480
   camera (focal 520, integration grid 387×290) seeing 4096 points on the
   corner of two planes (a numpy copy of tests/synthetic.PlaneScene, wedge,
   0.4 px keypoint noise, 10% outlier matches, depth priors with a 0.9-1.1
   scale error and 2% noise), verified by Correspondences.populate on the
   card; the launch counts set to 0 just before. Held: every image
   registered, ATE after a similarity alignment below 0.05, at least 40% of
   the points in the map, int_covs applied and point covariances parked,
   each of K1, K1 many, K2 and K3 launched; printed: the wall, the
   registered count and order, points, ATE, launches, each registration's
   wall and the phase timers. Then K1 on the last global BA's reduced
   system, K2 on the phase's PCG with the most lanes (then CG iterations)
   and on its PCG with the most CG iterations, and K3 at
   int_covs_bundle_batched's shapes of the final map, each held to its
   plain version and timed. Last, the small scene of
   __graft_entry__.dryrun_pipeline (5 images × 200 points, seed 3) mapped
   on the card and on the CPU from one verification and the same
   registration samples: the same images in the same order, point counts
   within 5%, both ATEs below 0.05.
10. The main path from images (slice 7): the port's pipeline.reconstruct
   on the card over an RGB-D directory rendered here in numpy (the mapping
   phase's geometry cut to 8 images: 640×480 at focal 520 on the corner of
   two planes, each textured with a multi-octave noise; 8-bit gray PNGs, .npy
   sensor depth with 1% log-normal noise, intrinsics.yaml in its JSON
   form), under configs/classical-nn_measured.yaml (dist_ba off, caches
   and depth output in the directory store: the card's host has no h5py):
   pairs, classical features, mutual-NN matches, measured priors,
   Correspondences.populate, ImagePriors, MpsfmMapper and the COLMAP
   model. A warm-up run on a copy of the directory, then the measured run
   with the launch counts set to 0 just before. Held: every stage's work
   on the card, each of K1, K1 many, K2 and K3 launched, 8/8 registered,
   ATE below 0.02, at least 4200 points, the written text model read back
   equal to the map; printed: each pipe.* phase's wall, frames/s,
   registered images, points, ATE and launches. Then tests/
   test_pipeline_e2e.py's scene (5 images of 320×240) and conf card vs
   CPU: the detector's keypoints as sets (≥ 99% within 0.01 px), the
   matcher's matches, and the mapping on the CPU from the card's caches
   (the same registered images, points within 5%, ATEs below 0.05).

11. The extraction modes off the main path (slice 10): (a) the port's
   pipeline.reconstruct on the card in the sparse+dense+measured mode with
   heuristic sky masks over the pipeline phase's geometry cut to 5 images
   of 640×480 (10 pairs, at most 4096 dense NCC matches each), after a
   warm-up on its first 2 images, with the launch counts at 0 just before.
   Held: every stage on the card (the NCC flow and the masks too), each
   kernel launched, 5/5 registered, ATE below 0.02, a points floor set from
   the JAX package's count over the same render, the written model read
   back, each kernel held to its plain version at the run's shapes;
   printed: wall, frames/s, each pipe.* phase, points, the dense matches a
   pair, the launches. (b) The dense-anchored matcher and (c) the
   pair-depth mode on tests/test_pipeline_e2e.py's scene and conf: >= 4 of 5
   registered, the anchored matches within 15 px of their pair's median
   flow above 60%, the pair-depth store's depth entries. (d) Card against
   CPU: the NCC flow of one 640×480 pair (flows equal at >= 99% of the
   grid, certainties within 1e-5 where equal), the sky heuristic on a
   640×480 image with a blue band (>= 99.9% of the mask equal), the onnx
   path with a fake session at 701×800 (>= 99.9%, the net's input within
   1e-4); the NCC flow, a mask, a guided upsample and a pyrDown ladder
   timed on the card.

12. The sparse BA solver (slice 8): solve_ba on the bench bundle with its
   per-(point, camera) tables (the dense-Schur route, K1 once an LM
   iteration), 20 LM iterations against solve_ba_dense (t within 5e-3,
   xyz within 2e-2, costs within 5%), K1 held to its plain version on the
   last reduced system; then the large route: a Reconstruction of the
   JAX package's 500+ image BA bench's sweep (points seen by 6
   consecutive cameras, 0.5 px noise, poses perturbed), cut to 128 images
   × 65 536 points, with ImagePriors on 8 images at 290×387, through
   run_scene_refinement once with the launch counts at 0 (no warm-up run
   of its own since the distributed BA phase came): point covariances at
   K = 768 (K1 many), the global step whose
   ba_fused falls back to solve_ba on the block-sparse Schur tables, the
   local step (dense, K1), refine_3d_points. Held: covariances finite,
   symmetric, positive definite; each BA's cost below its start; the
   global BA on the block-sparse tables; poses and points closer to the
   truth; every kernel launched, and held to its plain version at the
   route's shapes (K1 many on its first 24 576 columns, timed on all);
   printed: each entry point's wall, build_ba_data's host time with
   make_block_schur_tables apart, the peak device memory, launches, K1
   many's three kernels at K = 3072, and solve_ba's LM iterations/s and
   CG iterations per LM step on the global BA's problem. Last,
   test_block_schur_full_solve_parity's bundle (16 × 1024) solved with the
   block-sparse tables on the card and on the CPU and matrix-free on the
   card: final costs within 2% + 1e-3.
13. The distributed BA (slice 9), in worker processes of this script
   (`--dist-worker`; the main process never holds a process group, and
   every worker is waited for or killed): (a) on a world-size-1 NCCL
   group, solve_ba_block_sharded on the full-width sweep (512 × 131 072,
   the block-Schur route) against solve_ba on the same data: cost0
   within 1e-5 relative, the final costs within 1e-3 and at or below the
   cost at the truth, the same steps taken and refused by both over the
   first two (the sweep's cost then sits at float32's resolution); (b)
   two gloo ranks sharing the card (NCCL refuses two ranks on one card)
   on the bench bundle, the block-Schur and the dense-T route
   (MPSFM_DIST_BS=0): the ranks bit-identical, against solve_ba at
   tests/test_parallel.py's bounds (cost0 1e-5, cost 1e-3, quat 1e-5,
   xyz 1e-3), K1 launched every step of the dense-T route and held to
   its plain version at its reduced system (K = 384); (c) on the same
   two ranks the twin of tests/multihost_mapper_worker.py (the 5-image
   PlaneScene, dist_ba on): the same decisions and bit-identical poses
   on both ranks, sharded BAs, and the same decisions as one process
   with dist_ba off. Printed: wall times, all-reduces and bytes per LM
   step. Neither group is a multi-card measurement.
14. The flagship neural extraction (slice 11), run after 11 and before 12:
   seeded checkpoints in the official layouts (superpoint_v1.pth,
   superpoint_lightglue.pth, metric_depth_vit_small_800k.pth with
   depth_model. prefixes, a NetVLAD torch export with its whitening)
   written to a temporary directory and loaded through the port's loaders,
   manifest-checked. (a) At full width on the card: SuperPoint (6000
   keypoints, NMS radius 4, threshold 0.005) on the pipeline render cut to 5
   images of 640×480, LightGlue (9 × 256 × 4 heads) on every pair of them in
   bfloat16 and float32, timed per pair at the run's bucket and at 2048
   (each type's launches of K4's two kernels counted: its own kernel 36
   times a forward, the other never), the seeded LightGlue's bfloat16
   matches0 with K4 against the plain attention on the card, on (d)'s
   SuperPoint features of the images (every mutual argmax kept; at least
   99% of the entries equal; the plain bfloat16 run against float32
   printed beside it),
   NetVLAD (K = 64, D = 512, resize_max 640), Metric3Dv2-small at its
   616×1064 crop (44×76 patches + 5 tokens), and Metric3Dv2-giant2 once
   (weights drawn on the card; finite, shaped; wall and peak memory
   printed). (b) Card against CPU from the same seeded weights: SuperPoint's
   keypoints as sets (>= 99% within 0.01 px) and descriptors (1e-4),
   LightGlue's float32 scores (1e-4) and mutual-argmax matches (>= 99%) on
   one pair cut to 1024 keypoints, the NetVLAD descriptor (1e-4 of its
   largest entry), Metric3Dv2-small's depth and normals (1e-3 relative) at a
   308×532 crop. (c) K4 against attention_plain at the shapes LightGlue
   ran (its first self- and cross-attention call at each bucket, in each
   type) and at hd = 16: float32 (attention.cu) within 2e-5, bfloat16 (the
   tensor-core attention_tc.cu) within k4_bf16_bound (2u · plain(q, k, |v|)
   + one bfloat16 ulp + 2e-5, u = 2^-8); each kernel, the plain version
   and scaled_dot_product_attention (timed only) timed, the bound (over the
   real keys: a masked key's weight is 0) printed.
   (d) The port's reconstruct under configs/sp-lg_m3dv2-small.yaml with
   NetVLAD retrieval over the 5 images, the launch counts at 0 just before;
   its SuperPoint is drawn He-normal with zero-mean filters (the seeded
   one's descriptors agree to a cosine of 0.9999) and its LightGlue is the identity-block net of the
   same layout (each block returns its input, final_proj 80·I), since the
   seeded pair keeps no match: held that it reaches its end, every net's tensors
   and every stage on the card, the pairs from NetVLAD, the feature, match
   and depth stores written, the depth store equal to a direct infer_image,
   K4's tensor-core kernel launched 36 times a (bfloat16) LightGlue
   forward and the float32 one never, matches kept, at least 2
   images registered with points, K1 and K2 launched; printed: each pipe.*
   wall, the matches a pair, registered images, points and the launches.
   How many images register, the points' count and ATE are not held: the
   weights are seeded.
15. The paper's nets (slice 14), run after 14: seeded checkpoints in the
   official layouts (dsine.pth, roma_outdoor.pth, dinov2_vitl14_pretrain.pth,
   drawn on the card at the pinned manifests' names and shapes) loaded
   through the port's loaders, manifest-checked. (a) At full width on the
   card over 14's render (5 images of 640×480): DSINE-B5 on every image,
   one pass and the flipped pair (unit normals, positive variances); RoMa
   (DINOv2 ViT-L/14, VGG19-BN, the GP, 5 decoder blocks, the refiners) at
   672² on each of the 10 pairs, timed by stage, K1 many launched once a
   pair by the GP's K_bb solve (K = 48² = 2304, N = 512). (b) Card against
   CPU, cut: DSINE-B5 on one image at 320×240 (normals within 1e-3, the
   variance within 1e-3 of its largest), RoMa's forward on one pair at 224²
   (flow within 1e-3 and certainty logits within 1e-3 of their largest on
   >= 99% of the pixels). (c) K1 many against its plain version at the GP's
   own K_bb and right-hand sides (K1_REL[0.01] and the float64 rule), timed
   beside the plain version, torch.linalg.cholesky + torch.cholesky_solve
   and torch.linalg.solve, with its bound. (d) The port's reconstruct over
   the 5 images under configs/paper/sp-lg_m3dv2.yaml (DSINE-kappa-fc
   normals with their flipped pass, flip consistency) and under
   configs/sp-roma-dense_m3dv2.yaml (the mutual-NN matches and RoMa's
   dense ones), both with Metric3Dv2-small and (d)'s mapping SuperPoint
   and LightGlue, the launch counts at 0 just before each: held that each
   reaches its outputs, the nets' tensors and forwards on the card, the
   depth store's normals2, the dense store's pairs and one K1 many launch
   by the GP a pair; printed: wall, each pipe.* phase, registered images,
   points and launches (not held: the weights are seeded).
16. The two-view nets (slice 15; two_view_phase's docstring).
17. The prior nets (slice 17, prior_nets_phase): DepthPro at its official
   width (951.9 M parameters seeded on the card in the HF layout, loaded
   through the port's manifest-checked loader) on the render's first 3
   images, timed by stage, 72 K4 launches a forward held, peak memory; K4
   at its patch encoder's shape against attention_plain, SDPA and the
   bound; card against CPU cut (1e-4 of each output's largest); the
   port's reconstruct under configs/sp-lg_depthpro.yaml on those images
   without sensor depth, 3/3 registered and every kernel held to its plain
   version at the run's shapes; fit_scene_prior on the card (the loss
   falling, 4 K4 launches a step through its autograd Function), one
   training step's gradients card against CPU, K4 at the trainer's hd 48
   shape; the reconstruct with the trained vit_mono prior, 3/3 registered.

`python3 chip_smoke.py --profile` adds one main-path run under
torch.profiler and prints its device time by kernel.

Prints the card's name and power limit, each kernel's times and launch
count, the wall time per phase (the depth-consistency check's with its 8
scores), the consistent scene's two scores, the estimators' times and
checks, the scene phase's checks and one line per wall time, the scene
refinement's checks and wall times and its launches (a line of their
own), the mapping phase's lines and launches, the pipeline phase's lines
and launches, the dense modes phase's lines and launches, the sparse BA phase's lines and launches,
the distributed BA's lines and launches, the neural extraction's lines and launches, the paper nets', the
two-view nets' and the prior nets' lines and launches, a `{"kernels": [...]}` line (K1 twice more, at the dense modes phase's last global BA and at the
distributed BA's dense-T route; K4's tensor-core kernel in bfloat16 with (d)'s launches and its float32 kernel
with (a)'s float32 launches, both at the neural phase's largest bucket; K1 many at the RoMa GP's K_bb with its
launches by the GP in 15 (d); K4 float32 at MASt3R's, DepthAnythingV2's, RoMa's, DepthPro's and the trained
prior's shapes with their runs' launches), and last
`{"ok": true, "device": {...}}`. Any failure exits non-zero before that
line. Without a CUDA card it exits 1 and prints no result. Inputs are
synthetic, made from a seed with numpy.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

SEED = 0
FULL = dict(n_cams=64, n_pts=8192, B=8, H=290, W=387)  # bench bundle; 640×480 images on the ≤387 px grid
SMALL = dict(n_cams=8, n_pts=256, B=2, H=48, W=64)
# integration conf of the main path (mpsfm_tpu/scene/image_priors.py defaults)
MAIN_BINI = dict(lambda1=1.0, lambda2=1.0, k=1.0, max_iter=10, cg_max_iter=1000, cg_tol=1e-3, tol=5e-2)
# int_covs of the main path (same defaults): the diag(H⁻¹) grid is downscaled by
# 2, its deflated PCG runs 16 iterations, and the depth std is floored at 1% of
# the prior depth
DOWNSCALE, COV_CG_ITERS, INT_COV_FLOOR = 2, 16, 0.01
# depth rows of the BA (mpsfm_tpu/mapper/optimizer.py defaults: rob_std 2, scale_filter_factor 1.5)
ROWS = dict(m_base=2.0, sff=1.5, min_trunc=-1e30, scale_filter=True, compute_trunc=True)
LM_ITERS = 20
# LM iterations of the small scene refinement card vs CPU that end before the rel_tol latch (a step that
# moves the cost by < 1e-6 relative) can fire in any of its BAs: up to there every step moves the cost by
# more than float32 order can
LATCH_FREE_ITERS = 8
IMG_W, IMG_H, FOCAL = 640.0, 480.0, 500.0
# the depth-consistency check of the main path (mapper/depth_consistency.py defaults): c and the
# whitened test's threshold, the score's threshold depth_cons_thresh, the local bundle of a query
# (mapper/mapper.py:52, local_bundle_size) and prior_std_multiplier (scene/priors.py:46), by which
# the variance grids are divided
DC = dict(c=15.0, valid_thresh=0.6, score_thresh=0.15, refs=5, psm=3.33)
DC_SCORE_TOL = 0.02  # |Δscore| allowed where counts differ at boundary pixels (tests/test_mapper_units.py)
# RANSAC of the two-view verification and of registration: the mapper's hypothesis budget
# (scene/correspondences.py:24, mapper/registration.py:347) and threshold (max_error 4 px)
NUM_HYP, MAX_ERROR_PX = 512, 4.0
# the estimators' scene: 66 pairs of 12 of the bundle's cameras (the pair count of
# scripts/bench_mapping.py's 12 images), 2048 matches each; PnP at 4096 2D-3D matches; 1 px of
# Gaussian noise on every keypoint and 30% outliers (random keypoints in the image)
TWO_VIEW_CAMS, TWO_VIEW_MATCHES, PNP_MATCHES, NOISE_PX, OUTLIERS = 12, 2048, 4096, 1.0, 0.3
# the scene phase: a Reconstruction of the bench bundle after the main path's BA (64 images, 8192
# points, each seen by every image), filtered at 4 px and COLMAP's 1.5 deg triangulation angle;
# SCENE_REDO of the points deleted and re-added; the native store held against the plain one on
# the first TWO_VIEW_CAMS images
SCENE_FILTER, SCENE_REDO = (4.0, 1.5), 0.1

# published peaks of one H100 SXM: float32 outside the tensor cores, HBM
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

K1_TOL = 1e-4  # max |Δx| of K1 vs its plain version
# S = A·Aᵀ + shift·K·I: for each shift, the bound on max |Δx| / max |x| of K1
# vs its plain version and on the residual ‖S·x − b‖ / ‖b‖ of the kernel's x
# (float64). Two float32 orders differ by about a tenth of it; a trailing
# update that misses one 32×64 tile of one panel is off by a hundred times it
# or more, where the absolute bound alone may not see it (|x| ~ 1e-3 at shift 1).
K1_REL = {1.0: 1e-5, 0.01: 1e-4}
# The point-covariance systems of the mapping and pipeline phases (κ ≈ 4e8 .. 1.2e9, the diagonal
# 1 .. 1e9): float32 alone leaves the plain version 2e-5 to 3e-3 (max relative) and 4e-4 to 1.4e-3
# (residual) from the float64 solve there (H100), so kernel and plain are held within K1_ILL_REL of
# each other (a missed tile is off by O(1)), and the kernel no farther from the float64 solve, in
# either measure, than K1_ILL_RATIO times the plain version is, as medians over S and
# K1_ILL_TRIALS - 1 copies of it perturbed at float32's rounding (rounding_ensemble). On one system
# the kernel's distance over the plain version's swings from 0.05 to 36 between such copies, and
# cuSOLVER's float32 solve is past 2x the plain version's on a quarter of them
# (k1_many_ill_probe.py), so one draw says nothing of the kernel; their medians do. Where the plain
# version itself is farther than K1_ILL_REL / K1_ILL_RATIO from the float64 solve on S (the covariances
# of a 128-camera sweep, 2.6e-2 on this sandbox's CPU), two float32 orders differ by as much, so kernel
# and plain are held within K1_ILL_RATIO times that distance instead (a missed tile is still off by O(1)).
# K1_TOL is an absolute bound, so it says nothing of float32 once max |X| is past 1: at the dense modes
# phase's κ 1.8e9 and max |X| 1.47 the plain version alone lies 3.5e-5 to 1.3e-4 from the float64 solve
# (H100), and a kernel 1.1e-4 from it had medians as near to the float64 solve as the plain version's. So
# with the float64 reference max |ΔX| is held within the larger of K1_TOL and K1_ILL_RATIO times twice the
# plain version's median distance from the float64 solve (two float32 solves each that far from it differ
# by up to twice as much) times max |X|; a missed tile is still off by O(max |X|).
K1_ILL_REL, K1_ILL_RATIO, K1_ILL_TRIALS = 1e-2, 2.0, 32
# With the float64 reference the kernel is held by its normwise backward error on S itself,
# η = max over the columns of ‖S·x − b‖ / (‖S‖₂‖x‖ + ‖b‖) (backward_error), within the larger of
# K1_ETA_C·K·2⁻²³, what a stable Cholesky guarantees at any condition number, and K1_ILL_RATIO times the
# plain version's own η (where float32 itself fails S, the sparse large route's κ 4e15 with clamped pivots).
# It was held by the forward error's medians before (the kernel's within K1_ILL_RATIO times the plain
# version's), which swing with κ: at the pipeline phase's κ 4.5e8 that rule failed two whole runs of
# chip_smoke.py on an H100 (2.02x in one; k1_many_flake_probe.py measures both rules' failure rates on
# nearby systems). A missed tile of the trailing update moves η to O(1e-3) or more (k1_lost_tile).
K1_ETA_C = 1.0
# max |Δz| in log-depth of K2 vs its plain version. Sound runs differ only in
# the order of the dot products' sums (1.6e-6 at the PCG's tolerance, 1.7e-5
# after the fixed budget's 5000 iterations, on an H100); k2_phase shows that a
# kernel whose CTA reads a stale or dropped halo at its seams fails it
# (fixed budget 1.7e-2 and 4.9e-3).
K2_TOL = 1e-4
# The integrations of the sparse BA's sweep (anchors priced by its covariances) are ill-conditioned:
# run for the same iterations, the float32 PCG drifts from a float64 run of it by 1e-6 over the first
# 20 iterations and by 0.15 after 317, the kernel and the plain version alike (H100), so two float32
# orders end 1.8e-2 apart. There K2 is held within K2_TOL of the plain version over K2_SHORT
# iterations, and over the whole budget no farther from the float64 run than K2_RATIO times the plain
# version is. On that PCG's inputs a stale or dropped halo at one CTA's seams (k2_seam_fault) is off by
# 0.13 and 8.3e-3 after 20 iterations (CPU).
K2_SHORT, K2_RATIO = 20, 2.0
# A PCG stopped by its tolerance: where a lane's residual stagnates near the tolerance, two float32 orders of the
# same solve can stop many iterations apart (the dense modes phase's widest PCG: a lane at 64 iterations on K2 and
# 50 on the plain version, 5.07e-2 apart, H100). On that PCG's inputs with the right-hand side and the tolerance
# drawn near the phase's, 4.5% of draws had a lane more than 1 iteration or K2_TOL apart, and a float64 run
# stopped by the same tolerance sided with either version (k2_flake_probe.py). k2_pcg_verdict holds every lane by
# K2_TOL and counts within K2_STALL, except a lane that fails that and stopped at another count: k2_stall_rule
# holds it by K2_SHORT's float64 rule at a fixed budget and by where it stopped (within the plain version's
# iterations at the tolerance times and over K2_RATIO).
K2_STALL = 1
# max |Δv| / v of K3's variances vs its plain version. Sound runs differ only in
# the order of the dot products' sums (4.7e-6 on an H100); k3_phase shows that a
# kernel that skips the deflation's projection (keeping the coarse start), or
# that drops p's halo row at a band edge, fails it (1.7e-2 and 3.6e-1).
K3_REL = 1e-3
# the covariances and variances of the small chain, card vs CPU: max |Δcov| /
# max |cov| and max |Δv| / v. The reduced camera system is ill-conditioned
# (κ ≈ 7e7 at the small bundle): one float32 ulp of S moves the covariances by
# 1.5e-4 of their max, and the card's sums differ from the CPU's by 7.2e-4 of
# it (tests/test_torch_covariance.py)
COV_REL, VAR_REL = 2e-3, 1e-3


# ---- synthetic inputs (numpy, from a seed) ----

def _rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def synthetic_bundle(n_cams=8, n_pts=256, seed=SEED, with_depth=True):
    """The JAX package's bench bundle (__graft_entry__._synthetic_ba_data):
    every camera observes every point, depth observations on the first
    quarter of the points; sparse camera-major arrays in numpy."""
    rng = np.random.default_rng(seed)
    f, cx, cy = FOCAL, IMG_W / 2, IMG_H / 2
    pts = np.stack(
        [rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(4, 9, n_pts)], -1
    ).astype(np.float32)
    quats, ts, uvs, zs = [], [], [], []
    for i in range(n_cams):
        q = np.array([1.0, 0, 0.02 * min(i, 15), 0])
        q /= np.linalg.norm(q)
        t = np.array([-0.3 * min(i, 15) - 0.02 * i, 0.02 * min(i, 15), 0.05 * min(i, 15)])
        quats.append(q)
        ts.append(t)
        p = pts @ _rotmat(q).T + t
        uv = p[:, :2] / p[:, 2:] * f + np.array([cx, cy])
        uvs.append(uv + rng.normal(scale=0.5, size=uv.shape))
        zs.append(p[:, 2])
    No = n_cams * n_pts
    cam_dof = np.ones((n_cams, 6), np.float32)
    cam_dof[0] = 0.0
    cam_dof[1, 3] = 0.0
    Sd = max(n_pts // 4, 1)
    d_n = n_cams * Sd
    d_log = np.log(np.concatenate([z[:Sd] for z in zs])) + rng.normal(scale=0.02, size=d_n)
    f32 = np.float32
    return SimpleNamespace(
        quat=np.stack(quats).astype(f32), t=np.stack(ts).astype(f32), cam_dof=cam_dof,
        fx=np.full(n_cams, f, f32), fy=np.full(n_cams, f, f32),
        cx=np.full(n_cams, cx, f32), cy=np.full(n_cams, cy, f32),
        xyz=(pts + rng.normal(scale=0.05, size=pts.shape).astype(f32)).astype(f32),
        point_var=np.ones(n_pts, f32),
        r_cam=np.repeat(np.arange(n_cams), n_pts).astype(np.int32),
        r_pt=np.tile(np.arange(n_pts), n_cams).astype(np.int32),
        r_uv=np.concatenate(uvs).astype(f32), r_valid=np.ones(No, f32),
        r_mag=np.ones(No, f32), r_scale=np.full(No, 1.5, f32),
        d_cam=np.repeat(np.arange(n_cams), Sd).astype(np.int32),
        d_pt=np.tile(np.arange(Sd), n_cams).astype(np.int32),
        d_logtarget=d_log.astype(f32), d_valid=np.full(d_n, 1.0 if with_depth else 0.0, f32),
        d_mag=np.full(d_n, 100.0, f32), d_scale=np.full(d_n, 2.0, f32),
    )


def ba_arrays(bundle):
    """The bundle as the fields of the JAX package's BAData (numpy): its
    arrays plus the point slot tables and the per-(point, camera) tables,
    built as __graft_entry__._synthetic_ba_data builds them."""
    from mpsfm_tpu_torch.ba.solver import make_pc_tables, make_slot_tables

    C, P = bundle.quat.shape[0], bundle.xyz.shape[0]
    No, Nd = bundle.r_cam.shape[0], bundle.d_cam.shape[0]
    arrays = dict(vars(bundle))
    arrays["r_pt_slots"], arrays["r_pt_slot_mask"] = make_slot_tables(bundle.r_pt, P)
    arrays["d_pt_slots"], arrays["d_pt_slot_mask"] = make_slot_tables(bundle.d_pt, P)
    arrays["pc_r_slot"], arrays["pc_r_mask"] = make_pc_tables(bundle.r_pt, bundle.r_valid, P, C, No // C)
    arrays["pc_d_slot"], arrays["pc_d_mask"] = make_pc_tables(bundle.d_pt, bundle.d_valid, P, C, Nd // C)
    return arrays


def synthetic_priors(bundle, B, H, W, seed=SEED, Ka=512, n_anchors=300):
    """Depth/normal priors of B images of the bundle on an H×W integration
    grid, with everything the refinement step takes: anchor rows
    (B,6,Ka) of every slot code (code >= 0 is the anchor's point, whose
    covariance the main path computes), gate state prev (B,2) (no lane
    integrated yet), the cached (z0, stat8) pair of each lane, the keypoint
    rows (grid coords, previous depth variances, point index, camera) for
    the BA's depth residuals, and the int_covs problem on the grid
    downscaled by DOWNSCALE: static and prior rows there, anchors at
    downscaled pixels, one query per keypoint row (padded with pixel (0, 0)
    to a multiple of 128) and the prior depth at each keypoint. The scene
    depth of image b is a slanted plane at the median depth of its points;
    the prior is that plane with 3% log-normal noise; the normals are the
    plane's. For the depth-consistency check: each lane's prior variance
    grid divided by prior_std_multiplier², the intrinsics at grid scale,
    each lane's neighbours and its rows against them (the JAX checker's)."""
    import torch

    from mpsfm_tpu_torch.integration.bini import build_prior2, build_static6, resize_log_dev
    from mpsfm_tpu_torch.mapper.depth_consistency import pair_rows

    rng = np.random.default_rng(seed + 1)
    C, P = bundle.quat.shape[0], bundle.xyz.shape[0]
    sx, sy = W / IMG_W, H / IMG_H
    fx, fy, cx, cy = FOCAL * sx, FOCAL * sy, IMG_W / 2 * sx, IMG_H / 2 * sy
    H2, W2 = H // DOWNSCALE, W // DOWNSCALE
    Sd = max(P // 4, 1)
    Kp = -(-Sd // 128) * 128
    cam_rows = np.linspace(0, C - 1, B).round().astype(np.int32)
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))

    def normal_covs(h, w):  # ~2° of normal noise
        return np.broadcast_to(np.eye(3) * (np.pi / 180 * 2) ** 2, (h, w, 3, 3))

    anch = np.zeros((B, 6, Ka), np.float32)
    anch[:, 0] = H  # padding: out of range, dropped
    anch[:, 4] = -1.0
    anch_ds = anch.copy()
    anch_ds[:, 0] = H2
    pairs, stat8_ds, z_gt = [], [], []
    gx = np.zeros((B, Sd), np.float32)
    gy = np.zeros((B, Sd), np.float32)
    sigma2 = np.ones((B, Kp), np.float32)
    dprior = np.ones((B, Kp), np.float32)
    rowcol = np.zeros((B, 2, Kp), np.int32)
    ptidx = np.full((B, Sd), P, np.int32)  # >= P: padding
    dc_var = np.zeros((B, H, W), np.float32)
    for b, c in enumerate(cam_rows):
        R = _rotmat(bundle.quat[c])
        pc = bundle.xyz @ R.T + bundle.t[c]
        u = (fx * pc[:, 0] / pc[:, 2] + cx).astype(np.float32)
        v = (fy * pc[:, 1] / pc[:, 2] + cy).astype(np.float32)
        seen = np.nonzero((pc[:, 2] > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H))[0]
        n = np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.15, 0.15), -1.0])
        n /= np.linalg.norm(n)
        d0 = float(np.median(pc[seen, 2]))
        depth = n[2] * d0 / (n[0] * (xx - cx) / fx + n[1] * (yy - cy) / fy + n[2])
        prior = depth * np.exp(rng.normal(scale=0.03, size=depth.shape))
        static6 = build_static6(np.ones((H, W), bool), np.broadcast_to(n, (H, W, 3)), normal_covs(H, W),
                               fx, fy, cx, cy)
        prior2 = build_prior2(prior, (prior * 0.05) ** 2)
        dc_var[b] = ((prior * 0.05) ** 2).astype(np.float32) / np.float32(DC["psm"] ** 2)
        pairs.append((np.log(prior).astype(np.float32), np.concatenate([prior2, static6]).astype(np.float32)))
        z_gt.append(np.log(depth).astype(np.float32))
        # the int_covs grid: the prior resized, the static rows at the downscaled intrinsics
        prior_ds = np.exp(resize_log_dev(torch.as_tensor(np.log(prior), dtype=torch.float32), 0.0, (H2, W2)).numpy())
        static6_ds = build_static6(np.ones((H2, W2), bool), np.broadcast_to(n, (H2, W2, 3)), normal_covs(H2, W2),
                                   fx / DOWNSCALE, fy / DOWNSCALE, cx / DOWNSCALE, cy / DOWNSCALE)
        stat8_ds.append(np.concatenate([build_prior2(prior_ds, (prior_ds * 0.05) ** 2), static6_ds]).astype(np.float32))
        # keypoint rows: a random subset of the seen points, the rest padding
        kp = rng.permutation(seen)[:Sd]
        m = len(kp)
        ptidx[b, :m] = kp
        gx[b, :m], gy[b, :m] = u[kp], v[kp]
        iy, ix = np.clip(v[kp].astype(int), 0, H - 1), np.clip(u[kp].astype(int), 0, W - 1)
        sigma2[b, :m] = (0.05 * depth[iy, ix]) ** 2
        dprior[b, :m] = prior[iy, ix]
        rowcol[b, 0, :m] = np.clip(np.round(v[kp] / DOWNSCALE), 0, H2 - 1)
        rowcol[b, 1, :m] = np.clip(np.round(u[kp] / DOWNSCALE), 0, W2 - 1)
        # anchors: SfM depths at de-duplicated keypoint pixels, slot codes >=0 / -1 / -2
        pix = v[kp].astype(np.int64) * W + u[kp].astype(np.int64)
        _, first = np.unique(pix, return_index=True)
        sel = kp[np.sort(first)][:min(n_anchors, Ka)]
        L = len(sel)
        code = np.where(np.arange(L) % 3 == 0, sel, np.where(np.arange(L) % 3 == 1, -1, -2))
        ay, ax = v[sel].astype(np.int64), u[sel].astype(np.int64)
        d3 = depth[ay, ax] * np.exp(rng.normal(scale=0.01, size=L))  # SfM depth on the scene plane
        val = np.where(code == -2, d3 ** 2 / 1e-2, d3)  # -2: the value is the precision
        rows = np.stack([ay, ax, val, np.log(d3), code])
        anch[b, :5, :L] = rows
        # the int_covs grid's anchors: pixels rounded from the halved coordinates, the first on each pixel
        rows[0] = np.clip(np.round(v[sel] / DOWNSCALE), 0, H2 - 1)
        rows[1] = np.clip(np.round(u[sel] / DOWNSCALE), 0, W2 - 1)
        _, first = np.unique(rows[0] * W2 + rows[1], return_index=True)
        anch_ds[b, :5, :len(first)] = rows[:, np.sort(first)]
        anch[b, 5, 2:5] = anch_ds[b, 5, 2:5] = R[2]
    # the depth-consistency check: each lane the query against its up to DC["refs"] nearest lanes
    dc_refs = [sorted((r for r in range(B) if r != b), key=lambda r: (abs(r - b), r))[:DC["refs"]]
               for b in range(B)]
    poses = [(bundle.quat[c], bundle.t[c]) for c in cam_rows]
    dc_rows = np.stack([pair_rows(poses[b], [poses[r] for r in dc_refs[b]]) for b in range(B)])
    return SimpleNamespace(
        anch=anch, prev=np.zeros((B, 2), np.float32), pairs=pairs,
        z_gt=np.stack(z_gt), gx=gx, gy=gy, sigma2=sigma2, ptidx=ptidx, cam_rows=cam_rows,
        anch_ds=anch_ds, stat8_ds=stat8_ds, rowcol=rowcol, dprior=dprior, Sd=Sd,
        dc_var=dc_var, dc_refs=dc_refs, dc_rows=dc_rows, K_grid=grid_K(H, W),
    )


def grid_K(H, W):
    """Intrinsics of the 640×480 camera at the scale of an H×W grid."""
    sx, sy = W / IMG_W, H / IMG_H
    return np.array([[FOCAL * sx, 0, IMG_W / 2 * sx], [0, FOCAL * sy, IMG_H / 2 * sy], [0, 0, 1]], np.float32)


def lane_state(priors, dev):
    """The gate's inputs as tensors on dev: anchor rows, gate state and the
    (z0, stat8) pair of each lane."""
    import torch

    def t(a):
        return torch.as_tensor(a, device=dev)

    return t(priors.anch), t(priors.prev), [(t(z0), t(s8)) for z0, s8 in priors.pairs]


def make_inputs(n_cams, n_pts, B, H, W, seed=SEED):
    bundle = synthetic_bundle(n_cams, n_pts, seed)
    return SimpleNamespace(bundle=bundle, ba=ba_arrays(bundle), priors=synthetic_priors(bundle, B, H, W, seed),
                           C=n_cams, P=n_pts)


# ---- the main path ----

def run_slice(inputs, device, lm_iters=LM_ITERS, phases=None, floor=INT_COV_FLOOR):
    """The refinement step on `device`, through the port's entry points,
    in the JAX package's order (Mapper: calculate_point_covs, then
    Optimizer.ba_fused with the int_covs chain of _integrate_deferred, the
    depth-consistency check of each refined lane against its neighbours,
    then the BA), with the depth std floored at `floor` of the prior depth
    (0: the reference's unfloored mode). Returns a dict of tensors and
    numbers; `phases` (a dict) collects wall seconds per phase."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.ba.covariance import point_covariances
    from mpsfm_tpu_torch.ba.dense import densify, solve_ba_dense
    from mpsfm_tpu_torch.ba.device_depth import build_depth_grids, sample_logd
    from mpsfm_tpu_torch.integration.bini import (
        BiniParams,
        bini_gate_solve_batch_anchors,
        diag_inverse_gated_batch_anchors,
        resize_log_dev,
        take_z,
    )
    from mpsfm_tpu_torch.mapper.depth_consistency import bundle_score
    from mpsfm_tpu_torch.scene.image_priors import _changed_flag_dev, _updated_unc_dev

    phases = {} if phases is None else phases
    dev = torch.device(device)
    pr = inputs.priors

    def mark(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phases[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    dense = densify(inputs.bundle, inputs.C, inputs.P, device=dev)
    ba = convert.ba_data(inputs.ba, device=dev)
    anch, prev, pairs = lane_state(pr, dev)
    rows = [torch.as_tensor(a, device=dev)
            for a in (pr.gx, pr.gy, pr.sigma2, pr.ptidx, pr.cam_rows, pr.anch_ds, pr.rowcol, pr.dprior)]
    stat8_ds = [torch.as_tensor(a, device=dev) for a in pr.stat8_ds]
    dc_var, dc_K, dc_rows = (torch.as_tensor(a, device=dev) for a in (pr.dc_var, pr.K_grid, pr.dc_rows))
    t0 = mark("upload", t0)
    cov = point_covariances(ba)
    t0 = mark("point_covs", t0)
    p = BiniParams(**MAIN_BINI)
    z, info4 = bini_gate_solve_batch_anchors(anch, prev, p, cov, *pairs)
    t0 = mark("bini_gate_solve", t0)
    gx, gy, sigma2_old, ptidx, cam_rows, anch_ds, rowcol, dprior = rows
    Bn, H2, W2 = z.shape[0], *stat8_ds[0].shape[-2:]
    pairs_ds = [(resize_log_dev(take_z(z, b), 0.0, (H2, W2)), stat8_ds[b]) for b in range(Bn)]
    flags = torch.stack([_changed_flag_dev(info4, b) for b in range(Bn)])
    varlog = diag_inverse_gated_batch_anchors(
        anch_ds, rowcol, p._replace(cg_max_iter=COV_CG_ITERS), 128, cov, flags, *pairs_ds)
    sigma2 = torch.stack([_updated_unc_dev(varlog, b, sigma2_old[b], dprior[b], info4, b, floor)
                          for b in range(Bn)])
    t0 = mark("int_covs", t0)
    dc_depth = torch.stack([torch.exp(take_z(z, b)) for b in range(Bn)])
    dc_counts = lane_dc_counts(dc_depth, dc_var, dc_K, dc_rows, pr.dc_refs)
    dc_scores = [bundle_score(c) for c in dc_counts]
    t0 = mark("dc", t0)
    logd = torch.stack([sample_logd(z[b], 0.0, gx[b], gy[b]) for b in range(Bn)])
    d_logt, d_w, d_scale, trunc = build_depth_grids(
        logd, sigma2[:, :pr.Sd], ptidx, cam_rows, dense.quat, dense.t, dense.xyz,
        ROWS["m_base"], ROWS["sff"], ROWS["min_trunc"], C=inputs.C, P=inputs.P,
        scale_filter=ROWS["scale_filter"], compute_trunc=ROWS["compute_trunc"],
    )
    dense = dense._replace(d_logt=d_logt, d_w=d_w, d_scale=d_scale)
    t0 = mark("depth_rows", t0)
    quat, t, xyz, info = solve_ba_dense(dense, max_iters=lm_iters)
    mark("dense_ba", t0)
    return dict(cov=cov, z=z, info4=info4, varlog=varlog, sigma2=sigma2, d_w=d_w, trunc=trunc,
                dc_depth=dc_depth, dc_var=dc_var, dc_K=dc_K, dc_rows=dc_rows, dc_counts=dc_counts,
                dc_scores=dc_scores, quat=quat, t=t, xyz=xyz,
                cost0=float(info["cost0"]), cost=float(info["cost"]), accepted=int(info["accepted"]))


def lane_dc_counts(depth, var, K, rows, refs):
    """The depth-consistency counts of each lane b as the query against its
    neighbours refs[b] (one _bundle_counts call per query and grid shape,
    as the JAX checker makes): depth and var (B, H, W), K (3, 3), rows
    (B, R, 32). Returns (B, R, 4): qry_nv, qry_v, ref_nv, ref_v."""
    import torch

    from mpsfm_tpu_torch.mapper.depth_consistency import _bundle_counts

    ones = torch.ones(2, device=depth.device)
    return torch.stack([
        _bundle_counts(depth[b], var[b], K, ones, depth[r], var[r], K.expand(len(r), 3, 3), rows[b],
                       DC["c"], DC["valid_thresh"])
        for b, r in enumerate(refs)
    ])


def dc_pixel_classes(depth, var, K, rows, b, j, r):
    """Per pixel, both directions of the pair (lane b, its j-th neighbour r):
    [(p2D, t, in-canvas, valid, occluded)] ×2."""
    import torch

    from mpsfm_tpu_torch.mapper.depth_consistency import _dir_maps, _pair_args

    q, rr, M_qr, M_rq, r2_qr, r2_rq = _pair_args(depth[b], var[b], K, torch.ones(2, device=depth.device),
                                                depth[[r]], var[[r]], K[None], rows[b, j:j + 1])
    args = (DC["c"], DC["valid_thresh"])
    return _dir_maps(*q, *rr, M_qr, r2_qr, *args), _dir_maps(*rr, *q, M_rq, r2_rq, *args)


def near_boundary(p, t, out_hw, tol=1e-5):
    """Pixels whose target lies within tol px of a pixel or canvas boundary,
    or whose |t| lies within tol relative of the test's threshold."""
    H2, W2 = out_hw
    u, v = p[..., 0], p[..., 1]

    def edge(x, n):
        return ((x - x.round()).abs() <= tol) | ((x + 0.5 - n).abs() <= tol)

    return edge(u, W2) | edge(v, H2) | ((t.abs() - DC["valid_thresh"]).abs() <= tol * DC["valid_thresh"])


def dc_card_vs_cpu(out, inputs):
    """The main path's depth-consistency counts of the card against the
    CPU's on the same depth: equal, or every pixel classified differently
    within 1e-5 of a boundary (near_boundary, on either device's values)
    and every lane's score within DC_SCORE_TOL. Returns a line."""
    import torch

    from mpsfm_tpu_torch.mapper.depth_consistency import bundle_score

    pr = inputs.priors
    host = [torch.as_tensor(a) for a in (pr.dc_var, pr.K_grid, pr.dc_rows)]
    cpu = lane_dc_counts(out["dc_depth"].cpu(), *host, pr.dc_refs)
    card = out["dc_counts"].cpu()
    if torch.equal(card, cpu):
        return f"depth-consistency counts card vs CPU: equal ({card.numel()} counts)"
    dev = [out["dc_depth"], out["dc_var"], out["dc_K"], out["dc_rows"]]
    unexplained, n_diff = 0, 0
    for b, j in {(int(b), int(j)) for b, j, _ in torch.nonzero(card != cpu).tolist()}:
        r = pr.dc_refs[b][j]
        for mc, mg in zip(dc_pixel_classes(out["dc_depth"].cpu(), *host, b, j, r),
                          dc_pixel_classes(*dev, b, j, r)):
            diff = torch.zeros_like(mc[2])
            for a, g in zip(mc[2:], mg[2:]):
                diff |= a != g.cpu()
            hw = pr.dc_var.shape[-2:]
            near = near_boundary(mc[0], mc[1], hw) | near_boundary(mg[0].cpu(), mg[1].cpu(), hw)
            n_diff += int(diff.sum())
            unexplained += int((diff & ~near).sum())
    gap = max(abs(bundle_score(a) - bundle_score(c)) for a, c in zip(card, cpu))
    line = (f"depth-consistency counts card vs CPU: {int((card != cpu).sum())} of {card.numel()} differ, "
            f"{n_diff} pixels classified differently, {unexplained} of them not at a boundary; "
            f"max |Δscore| {gap:.3g} (tolerance {DC_SCORE_TOL})")
    if unexplained or not n_diff or gap > DC_SCORE_TOL:
        raise AssertionError(line)
    return line


def check_slice(out, inputs):
    """The main path's own checks; raises on the first that fails."""
    import torch

    for k in ("cov", "z", "info4", "varlog", "sigma2", "d_w", "quat", "t", "xyz"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"non-finite {k}")
    pr = inputs.priors
    B, H, W = pr.z_gt.shape
    if tuple(out["z"].shape) != (B, H, W) or tuple(out["xyz"].shape) != (inputs.P, 3):
        raise AssertionError("unexpected output shapes")
    if tuple(out["cov"].shape) != (inputs.P, 3, 3) or tuple(out["varlog"].shape) != pr.rowcol[:, 0].shape:
        raise AssertionError("unexpected covariance or variance shapes")
    cov = out["cov"].double().cpu().numpy()
    asym = np.abs(cov - cov.transpose(0, 2, 1)).max() / np.abs(cov).max()
    if not (asym < 1e-5 and (np.einsum("pii->pi", cov) > 0).all()):
        raise AssertionError(f"covariances not symmetric ({asym}) or with a non-positive diagonal")
    corr = np.corrcoef(inputs.bundle.xyz[:, 2], cov[:, 2, 2])[0, 1]
    if not corr > 0.2:  # deeper points are less certain (tests/test_ba.py:test_point_covariance_sanity)
        raise AssertionError(f"depth variance does not grow with depth: correlation {corr}")
    if not bool((out["varlog"] > 0).all()):
        raise AssertionError("a diag(H^-1) variance is not positive")
    info4 = out["info4"].cpu().numpy()
    if not (info4[:, 2] == 1).all() or (info4[:, 3] == 1).any():
        raise AssertionError(f"every lane should refine and none abort: {info4}")
    real = torch.as_tensor(pr.ptidx < inputs.P)
    moved = (out["sigma2"][:, :pr.Sd].cpu() != torch.as_tensor(pr.sigma2[:, :pr.Sd]))[real]
    if not bool(moved.all()):  # every lane changed here
        raise AssertionError(f"{int((~moved).sum())} keypoint variances of changed lanes did not move")
    if not out["cost"] < out["cost0"]:
        raise AssertionError(f"cost {out['cost']} not below cost0 {out['cost0']}")
    if out["accepted"] < 3:
        raise AssertionError(f"only {out['accepted']} accepted LM steps")
    if int((out["d_w"] > 0).sum()) == 0:
        raise AssertionError("no depth row has weight")
    z = out["z"].cpu().numpy()
    z0 = np.stack([q[0] for q in pr.pairs])
    err, err0 = np.abs(z - pr.z_gt).mean((1, 2)), np.abs(z0 - pr.z_gt).mean((1, 2))
    if not (err < 0.5 * err0).all():
        raise AssertionError(f"refined depth not closer to the truth: {err} vs prior {err0}")
    counts = out["dc_counts"].cpu()
    R = min(DC["refs"], B - 1)
    if tuple(counts.shape) != (B, R, 4) or not bool(((counts >= 0) & (counts <= H * W)).all()):
        raise AssertionError(f"depth-consistency counts of shape {tuple(counts.shape)}, not ({B}, {R}, 4) in [0, {H * W}]")
    valid = counts[..., [1, 3]].sum(1)
    if not bool((valid > 0).all()) or not all(np.isfinite(out["dc_scores"])):
        raise AssertionError(f"a lane's depth-consistency check saw no valid pixel: {valid.tolist()}, {out['dc_scores']}")
    dc_line = dc_card_vs_cpu(out, inputs) if out["dc_depth"].is_cuda else None
    return dict(dc_line=dc_line, depth_err=float(err.mean()), prior_err=float(err0.mean()), cov_depth_corr=float(corr),
                var_ratio=float((out["sigma2"][:, :pr.Sd].cpu()[real] / torch.as_tensor(pr.sigma2[:, :pr.Sd])[real])
                                .median()))


# ---- kernel phases ----

# K1's two routes' launch counts (ba/cholesky.route): one kernel of a path, whichever route its K takes
K1_ROUTES = ("cholesky", "cholesky_grid")


def k1_launched():
    """K1's launches with one right-hand side so far, on either route."""
    from mpsfm_tpu_torch.ba import cholesky

    return cholesky.KERNEL.launches + cholesky.KERNEL_GRID.launches


def unlaunched(launches):
    """The counted kernels that a path's run launched no time, K1's two
    routes counted as one (a path's K1 calls take the route of their K)."""
    k1 = sum(launches.get(name, 0) for name in K1_ROUTES)
    return [name for name, n in launches.items() if n == 0 and not (name in K1_ROUTES and k1 > 0)]


def cuda_ms(fn, reps, warm=True):
    """Mean device time of fn() in ms over reps calls, after one warm call
    (warm=False where the caller has just run fn on the same inputs)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def k1_check(S, b, rel, what):
    """K1 vs its plain version on (S, b): finite, max |Δx| ≤ K1_TOL, max |Δx| /
    max |x| ≤ rel and ‖S·x − b‖ / ‖b‖ ≤ rel. Returns (x, max |Δx|, a line)."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    x = cholesky.cholesky_solve(S, b)
    ref = cholesky.cholesky_solve_plain(S, b)
    err = float((x - ref).abs().max())
    rel_err = err / float(ref.abs().max())
    b64 = b.double()
    res = float(torch.linalg.vector_norm(S.double() @ x.double() - b64) / torch.linalg.vector_norm(b64))
    line = (f"{what}: max|kernel - plain| {err:.3e} (tolerance {K1_TOL}), relative {rel_err:.2e}, "
            f"residual {res:.2e} (tolerance {rel}), max|x| {float(ref.abs().max()):.3g}")
    if not (bool(torch.isfinite(x).all()) and err <= K1_TOL and rel_err <= rel and res <= rel):
        raise AssertionError(f"K1 disagrees with its plain version: {line}")
    return x, err, line


def k1_bound_ms(K):
    """K1's bound at K in ms: (operations, bytes). K³/3 + 2K² FLOP at the
    float32 peak; S, rhs and x once over the memory rate."""
    return (K ** 3 / 3 + 2 * K * K) / PEAK_F32 * 1e3, 4 * (K * K + 2 * K) / PEAK_BYTES * 1e3


def k1_timed(S, b, plain_reps=2):
    """K1 at (S, b) on its route, the plain version and the library call
    (torch.linalg.cholesky + torch.cholesky_solve): ms each, and the bound."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    ms = cuda_ms(lambda: cholesky.cholesky_solve(S, b), 20)
    plain_ms = cuda_ms(lambda: cholesky.cholesky_solve_plain(S, b), plain_reps)
    lib_ms = cuda_ms(lambda: torch.cholesky_solve(b[:, None], torch.linalg.cholesky(S)), 20)
    ops_ms, bytes_ms = k1_bound_ms(S.shape[0])
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops_ms=ops_ms, bytes_ms=bytes_ms)


# K1's routes, timed against each other at these K (K1_CROSSOVER_K) to place ba/cholesky.GRID_MIN_K; its
# timings at K1_TIMED_K; its run-to-run identity over K1_SAME_RUNS runs at K1_SAME_K
K1_CROSSOVER_K = (96, 192, 384, 768, 1024)
K1_TIMED_K = (384, 1024, 2048, 3072)
K1_SAME_K, K1_SAME_RUNS = (1024, 3072), 10


def k1_phase(dev, rng):
    """K1 vs its plain version at K = 6 (one ragged panel), 390 (a ragged
    last panel), 384 (the bench bundle's 6C), 1024, 1030 (a ragged last panel,
    K % 4 = 2), 1536, 2048 and 3072, on S = A·Aᵀ + shift·K·I for each shift
    of K1_REL, each on its route (printed), and with a zeroed row and column
    (its pivot clamped to 1e-20) on both routes; times of the kernel, the
    plain version and the library call at K1_TIMED_K (shift 1); both routes
    timed at K1_CROSSOVER_K; K1_SAME_RUNS runs bit-identical at K1_SAME_K.
    Returns the K = 384 figures (the main path's shape)."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    def spd(K, shift):
        A = rng.normal(size=(K, K)).astype(np.float32)
        S = A @ A.T + shift * K * np.eye(K, dtype=np.float32)
        return S, rng.normal(size=K).astype(np.float32)

    out = {}
    for K in (6, 390, 384, 1024, 1030, 1536, 2048, 3072):
        parts, errs = [], []
        for shift, rel in K1_REL.items():
            S, b = (torch.as_tensor(a, device=dev) for a in spd(K, shift))
            _, err, line = k1_check(S, b, rel, f"shift {shift}")
            parts.append(line)
            errs.append(err)
            if shift == 1.0:
                S1, b1 = S, b
        line = f"K1 cholesky_solve K={K} ({cholesky.route(K)} route): " + "; ".join(parts)
        if K in K1_TIMED_K:
            t = dict(k1_timed(S1, b1, plain_reps=1 if K > 1024 else 2), err=max(errs))
            line += (f"; kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms, "
                     f"bound {max(t['ops_ms'], t['bytes_ms']):.5f} ms")
            if K == 384:
                out = dict(t)
        if K in K1_SAME_K:
            xs = [cholesky.cholesky_solve(S1, b1) for _ in range(K1_SAME_RUNS)]
            same = all(torch.equal(xs[0], x) for x in xs[1:])
            line += f"; {K1_SAME_RUNS} runs bit-identical: {same}"
            if not same:
                raise AssertionError(f"K1 at K={K}: {K1_SAME_RUNS} runs on one input differ")
        print(line)
    for K, z in ((42, 35), (390, 100), (1030, 1000)):  # z in the ragged last panel, in a full one, on the grid route
        S, b = spd(K, 1.0)
        S[z, :] = 0.0
        S[:, z] = 0.0
        b[z] = 0.0
        x, _, line = k1_check(torch.as_tensor(S, device=dev), torch.as_tensor(b, device=dev), K1_REL[1.0],
                              f"K1 cholesky_solve K={K} ({cholesky.route(K)} route), row and column {z} zeroed")
        if float(x[z]) != 0.0:
            raise AssertionError(f"K1 at a clamped pivot: x[{z}] = {float(x[z])}, not 0")
        print(line + f", x[{z}] = 0")
    k1_crossover(dev, spd)
    return out


def k1_crossover(dev, spd, rounds=3):
    """Both routes of K1 (cholesky.solve_on_route) timed in turns at
    K1_CROSSOVER_K on one S (shift 1), `rounds` times block, grid, grid,
    block: the measurement behind ba/cholesky.GRID_MIN_K (min, median and
    max of each route's ms)."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    parts = []
    for K in K1_CROSSOVER_K:
        S, b = (torch.as_tensor(a, device=dev) for a in spd(K, 1.0))
        ms = {False: [], True: []}
        for _ in range(rounds):
            for grid in (False, True, True, False):
                ms[grid].append(cuda_ms(lambda: cholesky.solve_on_route(S, b, grid), 20))
        med = {g: float(np.median(v)) for g, v in ms.items()}
        parts.append(f"K={K} one block {min(ms[False]):.4f} / {med[False]:.4f} / {max(ms[False]):.4f} ms, grid "
                     f"{min(ms[True]):.4f} / {med[True]:.4f} / {max(ms[True]):.4f} ms")
    print(f"K1 routes ({rounds} x block, grid, grid, block; min / median / max; GRID_MIN_K = "
          f"{cholesky.GRID_MIN_K}): " + "; ".join(parts))


def kernel_ms_by_name(fn, reps):
    """Device ms per call of fn() by kernel name (torch.profiler over reps
    calls, after one warm call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name] = ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return ms


def rounding_ensemble(S, n, seed=SEED):
    """S and n - 1 copies of it, each entry times 1 + 2⁻²³·e (e standard
    normal, symmetric in S): the same system up to float32's rounding."""
    import torch

    gen = torch.Generator(device=S.device).manual_seed(seed)
    out = [S]
    for _ in range(n - 1):
        e = torch.randn(S.shape, generator=gen, device=S.device, dtype=torch.float64)
        out.append((S.double() * (1 + 2.0 ** -23 * (e + e.T) / 2 ** 0.5)).to(S.dtype))
    return out


def f64_gaps(S, B, X):
    """(max |X − X₆₄| / max |X₆₄|, ‖S·X − B‖_F / ‖B‖_F) against the float64
    solve of S X₆₄ = B."""
    import torch

    S64, B64, X = S.double(), B.double().reshape(S.shape[0], -1), X.double().reshape(S.shape[0], -1)
    X64 = torch.cholesky_solve(B64, torch.linalg.cholesky(S64))
    return (float((X - X64).abs().max() / X64.abs().max()),
            float(torch.linalg.norm(S64 @ X - B64) / torch.linalg.norm(B64)))


def backward_error(S, B, X):
    """The normwise backward error of X as a solution of S X = B on the
    equilibrated system (float64): with d = sqrt(diag S), Ŝ = S / (d dᵀ),
    max over the columns of ‖(S·x − b) / d‖₂ / (‖Ŝ‖₂‖d·x‖₂ + ‖b / d‖₂), a
    column with x = b = 0 (the padding of a bucket) counting 0. Cholesky
    does not see a diagonal scaling, so this is the error its stability
    bounds at any condition number (a badly scaled S, diagonal 1 .. 1e9 as
    the point covariances', would otherwise hide an error in its small block
    behind ‖S‖₂)."""
    import torch

    K = S.shape[0]
    S64, B64, X64 = S.double(), B.double().reshape(K, -1), X.double().reshape(K, -1)
    d = torch.sqrt(torch.clamp(torch.diagonal(S64), min=1e-300))[:, None]
    r = torch.linalg.vector_norm((S64 @ X64 - B64) / d, dim=0)
    den = torch.linalg.matrix_norm(S64 / (d * d.T), ord=2) * torch.linalg.vector_norm(d * X64, dim=0)
    den = den + torch.linalg.vector_norm(B64 / d, dim=0)
    return float(torch.where(den > 0, r / den.clamp_min(1e-300), r).max())


def k1_eta_bound(K):
    """The backward error a stable float32 Cholesky solve keeps below at any
    condition number: K1_ETA_C · K · 2⁻²³."""
    return K1_ETA_C * K * 2.0 ** -23


def k1_lost_tile(S, B, panel=0, tile=(0, 0)):
    """A planted fault for the K1 rules: cholesky_solve_plain with one NB × NB
    tile of one panel's trailing update skipped (`tile` in NB-row blocks
    below the panel), the fault of a CTA that drops its tile."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    K, NB = S.shape[0], cholesky.NB
    A = torch.tril(S)
    for c0 in range(0, K, NB):
        c1 = min(c0 + NB, K)
        D = A[c0:c1, c0:c1]
        for j in range(c1 - c0):
            D[j, j] = torch.sqrt(torch.clamp(D[j, j], min=1e-20))
            D[j + 1:, j] /= D[j, j]
            D[j + 1:, j + 1:] -= torch.outer(D[j + 1:, j], D[j + 1:, j])
        L11 = torch.tril(D)
        A[c0:c1, c0:c1] = L11
        if c1 < K:
            L21 = cholesky._solve_lower(L11, A[c1:, c0:c1].T).T
            A[c1:, c0:c1] = L21
            upd = L21 @ L21.T
            if c0 == panel * NB:
                upd[NB * tile[0]: NB * (tile[0] + 1), NB * tile[1]: NB * (tile[1] + 1)] = 0
            A[c1:, c1:] -= upd
    y = B.clone()
    for c0 in range(0, K, NB):
        c1 = min(c0 + NB, K)
        y[c0:c1] = cholesky._solve_lower(A[c0:c1, c0:c1], y[c0:c1])
        y[c1:] -= A[c1:, c0:c1] @ y[c0:c1]
    for c0 in reversed(range(0, K, NB)):
        c1 = min(c0 + NB, K)
        y[c0:c1] -= A[c1:, c0:c1].T @ y[c1:]
        y[c0:c1] = cholesky._solve_lower(A[c0:c1, c0:c1], y[c0:c1], transpose=True)
    return y


def k1_many_check(S, Bm, rel, what, f64=False):
    """K1 many (K1 on its route where Bm is one right-hand side (K,)) vs
    its plain version on (S, Bm): one launch, finite, max |ΔX|
    ≤ K1_TOL, max |ΔX| / max |X| ≤ rel and ‖S·X − B‖_F / ‖B‖_F ≤ rel. With
    f64, the kernel's backward error on S (backward_error) within the larger
    of k1_eta_bound(K) and K1_ILL_RATIO times the plain version's (the
    kernel's and the plain version's max relative error and residual
    against the float64 solve, as medians over rounding_ensemble(S,
    K1_ILL_TRIALS), printed beside it), max |ΔX| / max |X| within the larger of
    rel and K1_ILL_RATIO times the plain version's relative distance from
    the float64 solve on S, and max |ΔX| within the larger of K1_TOL and
    2·K1_ILL_RATIO times the plain version's median relative distance times
    max |X| (K1_ILL_REL's note). Returns (max |ΔX|, a line)."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    if Bm.dim() == 2:
        counter = cholesky.KERNEL_MANY
    else:  # one right-hand side: K1 on its route
        counter = cholesky.KERNEL_GRID if cholesky.route(S.shape[0]) == "grid" else cholesky.KERNEL
    n0 = counter.launches
    X = cholesky.cholesky_solve(S, Bm)
    if counter.launches != n0 + 1:
        raise AssertionError(f"{counter.name} was not launched")
    ref = cholesky.cholesky_solve_plain(S, Bm)
    err = float((X - ref).abs().max())
    rel_err = err / float(ref.abs().max())
    S64, B64 = S.double(), Bm.double()

    def residual(Y):
        return float(torch.linalg.norm(S64 @ Y.double() - B64) / torch.linalg.norm(B64))

    res = residual(X)
    if f64:
        gaps = [f64_gaps(S_t, Bm, X if t == 0 else cholesky.cholesky_solve(S_t, Bm))
                + f64_gaps(S_t, Bm, ref if t == 0 else cholesky.cholesky_solve_plain(S_t, Bm))
                for t, S_t in enumerate(rounding_ensemble(S, K1_ILL_TRIALS))]
        e_k, r_k, e_p, r_p = np.median(np.array(gaps), axis=0)
        rel_bound = max(rel, K1_ILL_RATIO * gaps[0][2])  # K1_ILL_REL's note
        abs_bound = max(K1_TOL, 2 * K1_ILL_RATIO * e_p * float(ref.abs().max()))
    else:
        rel_bound, abs_bound = rel, K1_TOL
    line = (f"{what}: max|kernel - plain| {err:.3e} (tolerance {abs_bound:.3g}), relative {rel_err:.2e} (tolerance "
            f"{rel_bound:.3g}), residual {res:.2e} (tolerance {rel}), max|X| {float(ref.abs().max()):.3g}")
    ok = bool(torch.isfinite(X).all()) and err <= abs_bound and rel_err <= rel_bound and res <= rel
    if f64:
        eta_k, eta_p = backward_error(S, Bm, X), backward_error(S, Bm, ref)
        eta_bound = max(k1_eta_bound(S.shape[0]), K1_ILL_RATIO * eta_p)
        line += (f"; backward error kernel {eta_k:.2e}, plain {eta_p:.2e} (tolerance {eta_bound:.3g}); against the "
                 f"float64 solve, medians over S and {K1_ILL_TRIALS - 1} copies at float32's rounding: kernel "
                 f"{e_k:.2e} relative, residual {r_k:.2e}; plain {e_p:.2e}, {r_p:.2e} (on S alone kernel "
                 f"{gaps[0][0]:.2e}, plain {gaps[0][2]:.2e})")
        ok = ok and eta_k <= eta_bound
    if not ok:
        raise AssertionError(f"{'K1 many' if Bm.dim() == 2 else 'K1'} disagrees with its plain version at "
                             f"K={S.shape[0]}, N={Bm.shape[-1] if Bm.dim() == 2 else 1}: {line}")
    return err, line


def k1_many_parts(by_name):
    """K1 many's device ms by part from kernel_ms_by_name: the factorization
    (either route's kernel), the packing and the substitution."""
    parts = {"factorization": ("chol_solve_kernel", "chol_grid_kernel"), "packing": ("chol_pack_kernel",),
             "substitution": ("chol_subst_kernel",)}
    return {what: sum(t for n, t in by_name.items() if any(k in n for k in keys)) for what, keys in parts.items()}


def k1_many_phase(dev, rng):
    """K1 with many right-hand sides vs its plain version at K = 384, N =
    24 576 (the covariances' solve at the bench bundle: 6C × 3P), K = 390,
    N = 1000 (a ragged last block and column tile), K = 3072, N = 1000 (512
    cameras, the JAX package's largest dense covariance), K = 33, N = 24 577
    (ragged, N no multiple of 4) and K = 1030, N = 65 (the grid route's
    factorization at a ragged K), on S = A·Aᵀ + shift·K·I for each
    shift of K1_REL: max |ΔX| ≤ K1_TOL, max |ΔX| / max |X| and ‖S·X − B‖_F /
    ‖B‖_F within the shift's bound. Times of the kernel, the plain version
    and the library call at the main shape, and of the kernel's three
    launches apart (the substitution beside its bound and the library's
    substitution with a given factor)."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    out = {}
    for K, N in ((384, 24576), (390, 1000), (3072, 1000), (33, 24577), (1030, 65)):
        parts, errs = [], []
        for shift, rel in K1_REL.items():
            A = rng.normal(size=(K, K)).astype(np.float32)
            S = torch.as_tensor(A @ A.T + shift * K * np.eye(K, dtype=np.float32), device=dev)
            Bm = torch.as_tensor(rng.normal(size=(K, N)).astype(np.float32), device=dev)
            err, line = k1_many_check(S, Bm, rel, f"shift {shift}")
            parts.append(line)
            errs.append(err)
            if shift == 1.0:
                S1, B1 = S, Bm
        line = f"K1 cholesky_solve K={K}, N={N}: " + "; ".join(parts)
        if N == 24576:
            ms = cuda_ms(lambda: cholesky.cholesky_solve(S1, B1), 10)
            plain_ms = cuda_ms(lambda: cholesky.cholesky_solve_plain(S1, B1), 2)
            lib_ms = cuda_ms(lambda: torch.cholesky_solve(B1, torch.linalg.cholesky(S1)), 10)
            flops = K ** 3 / 3 + 2.0 * K * K * N
            nbytes = 4.0 * (K * K + 2 * K * N)
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library {lib_ms:.4f} ms, "
                     f"bound {max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3:.5f} ms")
            out = dict(err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       ops_ms=flops / PEAK_F32 * 1e3, bytes_ms=nbytes / PEAK_BYTES * 1e3)
            by_name = kernel_ms_by_name(lambda: cholesky.cholesky_solve(S1, B1), 10)
            L1 = torch.linalg.cholesky(S1)
            lib_subst = cuda_ms(lambda: torch.cholesky_solve(B1, L1), 10)
            subst_bound = 2.0 * K * K * N / PEAK_F32 * 1e3
            got = k1_many_parts(by_name)
            if not all(got.values()):
                raise AssertionError(f"K1 many's kernels not all seen by the profiler: {sorted(by_name)}")
            print(f"K1 many K={K}, N={N} by kernel (torch.profiler, 10 calls): "
                  + ", ".join(f"{what} {t:.4f} ms" for what, t in got.items())
                  + f"; substitution bound {subst_bound:.5f} ms (2 K^2 N FLOP), library's substitution "
                  f"(torch.cholesky_solve, factor given) {lib_subst:.4f} ms")
        print(line)
    out["k3072"] = k1_many_covariance_shape(dev, rng)
    return out


def k1_many_covariance_shape(dev, rng, K=6 * 512, N=3 * 131072):
    """K1 many at the point covariances' shape of the sparse BA phase's
    full width (512 cameras × 131 072 points), on S = A·Aᵀ + K·I: held to
    its plain version on the first SPARSE_COV_COLS right-hand sides (its
    K1_REL[1.0] class), timed on all N beside the plain version, the
    library call, its three kernels apart and its bound. Returns the
    numbers."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    A = rng.normal(size=(K, K)).astype(np.float32)
    S = torch.as_tensor(A @ A.T + K * np.eye(K, dtype=np.float32), device=dev)
    Bm = torch.randn(K, N, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    err, line = k1_many_check(S, Bm[:, :SPARSE_COV_COLS].contiguous(), K1_REL[1.0],
                              f"K1 cholesky_solve K={K}, N={N} (the 512-camera covariances' shape), shift 1.0, held "
                              f"on {SPARSE_COV_COLS} columns")
    ms = cuda_ms(lambda: cholesky.cholesky_solve(S, Bm), 3)
    plain_ms = cuda_ms(lambda: cholesky.cholesky_solve_plain(S, Bm), 1)
    lib_ms = cuda_ms(lambda: torch.cholesky_solve(Bm, torch.linalg.cholesky(S)), 3)
    by_name = kernel_ms_by_name(lambda: cholesky.cholesky_solve(S, Bm), 2)
    got = k1_many_parts(by_name)
    if not all(got.values()):
        raise AssertionError(f"K1 many's kernels not all seen by the profiler: {sorted(by_name)}")
    flops, nbytes = K ** 3 / 3 + 2.0 * K * K * N, 4.0 * (K * K + 2 * K * N)
    print(f"{line}; kernel {ms:.3f} ms (" + ", ".join(f"{k} {v:.3f} ms" for k, v in got.items())
          + f"; torch.profiler, 2 calls), plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound "
          f"{max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3:.4f} ms (operations {flops / PEAK_F32 * 1e3:.4f}, bytes "
          f"{nbytes / PEAK_BYTES * 1e3:.4f})")
    return dict(K=K, N=N, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops_ms=flops / PEAK_F32 * 1e3,
                bytes_ms=nbytes / PEAK_BYTES * 1e3, **got)


def k3_inputs(pr, cov, dev, queries=None):
    """K3's inputs for the priors `pr`: each lane's int_covs problem (the
    downscaled grid, its anchors priced by the covariances `cov`) with the
    resized prior as z, its operator, the deflation set-up and the first
    `queries` keypoint queries (all by default); and the iteration count."""
    import torch

    from mpsfm_tpu_torch.integration import bini, bini_diag, bini_fused

    pairs = [(torch.as_tensor(s8[1], device=dev), torch.as_tensor(s8, device=dev)) for s8 in pr.stat8_ds]
    packed = bini._assemble_batch_anchors(torch.as_tensor(pr.anch_ds, device=dev), cov, pairs)
    inp = bini._unpack(packed)
    p = bini.BiniParams(**MAIN_BINI)
    wx, wy = bini_fused.weights(inp.z0, p.k)
    st, _, dg = bini._operator(inp, p, wx, wy)
    rowcol = torch.as_tensor(pr.rowcol[:, :, :queries], device=dev)
    return st, bini_diag.deflation(st, dg), rowcol[:, 0], rowcol[:, 1], COV_CG_ITERS


@contextlib.contextmanager
def k3_no_projection():
    """The plain deflated PCG turned into a kernel that skips the
    deflation's projection of the preconditioned residual (the coarse
    start stays)."""
    from mpsfm_tpu_torch.integration import bini_diag

    project = bini_diag.project
    bini_diag.project = lambda dfl, Z, V: V
    try:
        yield
    finally:
        bini_diag.project = project


@contextlib.contextmanager
def k3_seam_fault(row, iters):
    """The plain deflated PCG turned into a kernel whose band starting at
    `row` reads p's halo row (row − 1, the band above's last row) as 0:
    every H·p of the iterations is that of the sound kernel except on that
    band's first row, where the upper edge sees p(row − 1) = 0. The coarse
    start's H·x0 is analytic in the kernel and stays sound."""
    from mpsfm_tpu_torch.integration import bini_diag

    matvec = bini_diag.matvec
    calls = [0]

    def faulty(st, v):
        out = matvec(st, v)
        calls[0] += 1
        if calls[0] % (iters + 1) != 1:  # per chunk of queries: H·x0 first, then H·p of each iteration
            dropped = v.clone()
            dropped[..., row - 1, :] = 0.0
            out[..., row, :] = matvec(st, dropped)[..., row, :]
        return out

    bini_diag.matvec = faulty
    try:
        yield
    finally:
        bini_diag.matvec = matvec


def k3_check(what, args):
    """K3 vs its plain version: one launch, positive variances within
    K3_REL, bit-identical from run to run. Returns (variances, the plain
    version's, max |Δv| / v)."""
    import torch

    from mpsfm_tpu_torch.integration import bini_diag

    st, dfl, rows, cols, iters = args
    Bn, H, W = dfl.minv.shape
    pl = bini_diag.plan(H, W)
    n0 = bini_diag.KERNEL.launches
    v = bini_diag.deflated_pcg(*args)
    torch.cuda.synchronize()
    if bini_diag.KERNEL.launches != n0 + 1:
        raise AssertionError(f"K3 ({what}) made {bini_diag.KERNEL.launches - n0} launches, not 1")
    ref = bini_diag.deflated_pcg_plain(*args)
    rel = float(((v - ref).abs() / ref.abs()).max())
    same = bool(torch.equal(bini_diag.deflated_pcg(*args), v))
    where = "p and r in global memory" if pl.gmem else "p and r in shared memory"
    print(f"K3 deflated PCG ({what}: B={Bn} {H}x{W}, {rows.shape[1]} queries a lane, {iters} iterations; "
          f"clusters of C={pl.C} CTAs of {pl.bh} rows, R={pl.R} right-hand sides, {where}, {pl.smem} B of shared memory, "
          f"{bini_diag.active_clusters(H, W, dfl.minv.device)} clusters co-resident): max|kernel - plain| / plain = "
          f"{rel:.3e} (tolerance {K3_REL}); run to run {'bit-identical' if same else 'DIFFERENT'}; "
          f"variances {float(ref.min()):.3e} .. {float(ref.max()):.3e}")
    if not (bool((v > 0).all()) and rel <= K3_REL and same):
        raise AssertionError(f"K3 ({what}) disagrees with its plain version ({rel}) or is not bit-identical ({same})")
    return v, ref, rel


def k3_phase(dev, inputs, cov):
    """K3 vs its plain version at the main path's shapes (8 × 145×193,
    2048 queries a lane, 16 iterations) and at 2 × 193×193, 2 × 290×387
    (grids above one block's shared memory) and 2 × 400×600 (bands in global
    memory), 64 queries a lane: max |Δv| / v ≤ K3_REL, bit-identical from
    run to run, one launch each; the same check failing a kernel without the
    projection and one that drops p's halo row at a band edge; the global
    mode equal bit for bit to the shared-memory mode at the main grid (64
    queries a lane). Times of the kernel and the plain version at the main
    path's shapes and at 400×600, and of both modes at the main grid."""
    import torch

    from mpsfm_tpu_torch.integration import bini_diag

    args = k3_inputs(inputs.priors, cov, dev)
    st, dfl, rows, cols, iters = args
    Bn, H, W = dfl.minv.shape
    v, ref, rel = k3_check("main path", args)
    with k3_no_projection():
        bad = bini_diag.deflated_pcg_plain(*args)
    rel_bad = float(((bad - ref).abs() / ref.abs()).max())
    print(f"K3 check vs a kernel without the projection: max|Δv| / v = {rel_bad:.3e} (tolerance {K3_REL})")
    if rel_bad <= K3_REL:
        raise AssertionError("K3's check would pass a kernel without the deflation's projection")
    pl = bini_diag.plan(H, W)
    seam = pl.bh * (pl.C // 2)  # the first row of the middle band
    with k3_seam_fault(seam, iters):
        bad = bini_diag.deflated_pcg_plain(*args)
    rel_seam = float(((bad - ref).abs() / ref.abs()).max())
    print(f"K3 check vs a kernel that drops p's halo row above band {pl.C // 2} (row {seam - 1}): max|Δv| / v = "
          f"{rel_seam:.3e}, the sound kernel {rel:.3e} (tolerance {K3_REL})")
    if rel_seam <= K3_REL:
        raise AssertionError("K3's check would pass a kernel that drops a band's halo row")
    for h, w in ((193, 193), (290, 387)):  # an aspect of 1:1; downscaled: False at 4:3
        pr = synthetic_priors(inputs.bundle, 2, DOWNSCALE * h, DOWNSCALE * w)
        k3_check(f"{h}x{w}", k3_inputs(pr, cov, dev, queries=64))
    # bands of 50 rows of 600 pixels: above a CTA's shared memory at R = 1, global mode
    big = k3_inputs(synthetic_priors(inputs.bundle, 2, DOWNSCALE * 400, DOWNSCALE * 600), cov, dev, queries=64)
    if not bini_diag.plan(400, 600).gmem:
        raise AssertionError("the 400x600 plan should keep its bands in global memory")
    k3_check("400x600, global memory", big)
    big_ms = cuda_ms(lambda: bini_diag.deflated_pcg(*big), 2)
    big_plain_ms = cuda_ms(lambda: bini_diag.deflated_pcg_plain(*big), 1)
    print(f"K3 at 2 x 400x600, 64 queries a lane (global memory): kernel {big_ms:.3f} ms, plain {big_plain_ms:.3f} ms")
    # the global mode at the main grid's (C, R): the shared-memory mode's arithmetic, bit for bit
    few = k3_inputs(inputs.priors, cov, dev, queries=64)
    pl_g = pl._replace(gmem=True, smem=bini_diag.smem_bytes(H, W, pl.C, pl.R, gmem=True))
    shared = bini_diag._pcg_cuda(*few)
    glob = bini_diag._pcg_cuda(*few, pl=pl_g)
    torch.cuda.synchronize()
    if not torch.equal(glob, shared):
        raise AssertionError(f"K3's global mode differs from its shared-memory mode at {H}x{W}: "
                             f"max |Δv| / v {float(((glob - shared).abs() / shared.abs()).max())}")
    shared_ms = cuda_ms(lambda: bini_diag._pcg_cuda(*few), 3)
    glob_ms = cuda_ms(lambda: bini_diag._pcg_cuda(*few, pl=pl_g), 3)
    print(f"K3 global vs shared memory at B={Bn} {H}x{W}, 64 queries a lane, C={pl.C} R={pl.R}: bit-identical; "
          f"shared {shared_ms:.3f} ms, global {glob_ms:.3f} ms ({bini_diag.active_clusters(H, W, dev, pl_g)} "
          f"clusters co-resident in global mode)")
    ms = cuda_ms(lambda: bini_diag.deflated_pcg(*args), 2)
    plain_ms = cuda_ms(lambda: bini_diag.deflated_pcg_plain(*args), 1)
    n_rhs, n_pix = Bn * rows.shape[1], H * W
    # per pixel: 33 FLOP an iteration (stencil 13, p.Hp 2, r 2, M^-1 r 1,
    # (HZ)^T V 6, projection 5, r.z 2, p 2), 31 for the coarse start
    flops = float(n_rhs) * n_pix * (33 * iters + 31)
    nbytes = 4.0 * (7 * Bn * n_pix + 9 * Bn + H + W + 3 * n_rhs)  # maps, E^-1, axes, queries, variances
    # the design's reads of the maps from L2: 12 distinct values a pixel-iteration, once per group of R
    l2_bytes = 48.0 * Bn * -(-rows.shape[1] // pl.R) * n_pix * (iters + 1)
    print(f"K3: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3:.4f} ms; "
          f"the design's map reads from L2 {l2_bytes / 1e9:.1f} GB (R = {pl.R})")
    return dict(err=rel, ms=ms, plain_ms=plain_ms, library_ms=None,
                ops_ms=flops / PEAK_F32 * 1e3, bytes_ms=nbytes / PEAK_BYTES * 1e3)


@contextlib.contextmanager
def k2_card_holds(n):
    """K2's lane-group planner sees a card that holds n CTAs at once."""
    from mpsfm_tpu_torch.integration import bini_fused

    capacity = bini_fused._capacity
    bini_fused._capacity = lambda dev, W: n
    try:
        yield
    finally:
        bini_fused._capacity = capacity


@contextlib.contextmanager
def k2_seam_fault(kind, chunk, cta):
    """The plain PCG turned into a kernel with a faulty seam: from the second
    CG iteration on, CTA `cta` of every lane (pixels [cta·chunk, (cta+1)·chunk)
    of the flattened image) computes Ap from a halo whose p is that of the
    previous iteration (kind "stale": p_old read in place of p_new) or 0
    ("dropped"). Every other pixel's Ap is right."""
    import torch

    from mpsfm_tpu_torch.integration import bini_fused

    matvec, pcg_plain = bini_fused.matvec, bini_fused.pcg_plain

    def faulty_pcg(*args):
        seen = {"calls": 0, "prev": None}  # matvec is given A x0 first, then p of each iteration

        def faulty_matvec(st, v):
            out = matvec(st, v)
            if seen["calls"] >= 2:
                B = v.shape[0]
                s, e = cta * chunk, min((cta + 1) * chunk, v[0].numel())
                halo = seen["prev"] if kind == "stale" else torch.zeros_like(v)
                mix = halo.reshape(B, -1).clone()
                mix[:, s:e] = v.reshape(B, -1)[:, s:e]
                out = out.reshape(B, -1).clone()
                out[:, s:e] = matvec(st, mix.view_as(v)).reshape(B, -1)[:, s:e]
                out = out.view_as(v)
            seen["calls"] += 1
            seen["prev"] = v
            return out

        bini_fused.matvec = faulty_matvec
        try:
            return pcg_plain(*args)
        finally:
            bini_fused.matvec = matvec

    bini_fused.pcg_plain = faulty_pcg
    try:
        yield
    finally:
        bini_fused.pcg_plain = pcg_plain


def k2_stall_rule(args, active, far, x, iters, xr, iters_r):
    """K2_STALL's rule for the lanes `far` (CPU bool (B,)) that stopped
    elsewhere on K2 (x, iters) than on the plain version (xr, iters_r)
    (k2_pcg_verdict), on the PCG args (st, b, dg, x0, budget, tol):
    (a) K2_SHORT's float64 rule on those lanes at a fixed budget of their
    larger count: K2 within K2_TOL of the plain version over K2_SHORT
    iterations, and over the budget no farther from a float64 run of the
    plain version than K2_RATIO times the plain version is, + K2_TOL;
    (b) K2 stopped where the plain version's residual is within K2_RATIO
    of the tolerance: its count at least the plain version's at the
    tolerance times K2_RATIO and at most the plain version's at the
    tolerance over K2_RATIO. Returns (ok, a line of the numbers)."""
    import torch

    from mpsfm_tpu_torch.integration import bini_fused

    st, b, dg, z, budget_tol, tol = args
    on = active & far.to(active.device)
    budget = int(torch.maximum(iters, iters_r).cpu()[far].max())
    short = (st, b, dg, z, min(K2_SHORT, budget), -1.0)
    fixed = (st, b, dg, z, budget, -1.0)
    e_short = lane_max_abs(bini_fused.pcg(*short, on)[0] - bini_fused.pcg_plain(*short, on)[0])[far]
    x64, _ = bini_fused.pcg_plain(bini_fused.Stencil(*(t.double() for t in st)), b.double(), dg.double(),
                                  z.double(), budget, -1.0, on)
    d_k, d_p = (lane_max_abs(bini_fused.pcg(*fixed, on)[0].double() - x64)[far],
                lane_max_abs(bini_fused.pcg_plain(*fixed, on)[0].double() - x64)[far])
    lo, hi = (bini_fused.pcg_plain(st, b, dg, z, budget_tol, t, on)[1].cpu()[far] for t in (tol * K2_RATIO,
                                                                                            tol / K2_RATIO))
    it = iters.cpu()[far]
    ok_a = (e_short <= K2_TOL) & (d_k <= K2_RATIO * d_p + K2_TOL)
    ok_b = (lo <= it) & (it <= hi)
    fmt = lambda t: [f"{v:.3e}" for v in t.tolist()]  # noqa: E731
    line = (f"lanes {far.nonzero().flatten().tolist()} stopped elsewhere (iterations kernel {it.tolist()}, plain "
            f"{iters_r.cpu()[far].tolist()}), held by K2_STALL's rule: (a) at a fixed {budget} iterations, over "
            f"{min(K2_SHORT, budget)} max|kernel - plain| {fmt(e_short)}, from the float64 run kernel {fmt(d_k)}, "
            f"plain {fmt(d_p)}: {ok_a.tolist()}; (b) the plain version's iterations at the tolerance x {K2_RATIO} "
            f"{lo.tolist()} and / {K2_RATIO} {hi.tolist()} around the kernel's: {ok_b.tolist()}")
    return bool(ok_a.all() and ok_b.all()), line


def lane_max_abs(d):
    """max |d| over each lane of a (B, ...) tensor, float64 on the CPU."""
    return d.abs().reshape(d.shape[0], -1).amax(1).double().cpu()


def k2_pcg_verdict(args, active, x, iters, xr, iters_r):
    """The rule of k2_pcg_check on K2's (x, iters) and the plain version's
    (xr, iters_r) from the PCG args: a lane passes with counts within
    K2_STALL and max |Δx| ≤ K2_TOL; a lane that does not, with counts that
    differ, has stopped elsewhere (K2_STALL's note) and is held by
    k2_stall_rule; a lane with equal counts and max |Δx| > K2_TOL fails.
    Returns (ok, the stalled lanes (CPU bool), k2_stall_rule's line or
    None)."""
    gap = (iters - iters_r).abs().cpu()
    same = (gap <= K2_STALL) & (lane_max_abs(x - xr) <= K2_TOL)
    stalled = ~same & (gap > 0)
    ok, line = bool((same | stalled).all()), None
    if bool(stalled.any()):
        held, line = k2_stall_rule(args, active, stalled, x, iters, xr, iters_r)
        ok = ok and held
    return ok, stalled, line


def k2_pcg_check(what, args, active):
    """K2's PCG vs its plain version on the same inputs, by k2_pcg_verdict:
    per-lane iteration counts within K2_STALL and max |Δx| ≤ K2_TOL, a lane
    that stopped elsewhere held by k2_stall_rule. Returns (x, iterations,
    max |Δx|, the plain version's x and iterations)."""
    from mpsfm_tpu_torch.integration import bini_fused

    x, iters = bini_fused.pcg(*args, active)
    xr, iters_r = bini_fused.pcg_plain(*args, active)
    err = float((x - xr).abs().max())
    print(f"K2 pcg ({what}): max|kernel - plain| = {err:.3e} (tolerance {K2_TOL}); "
          f"iterations kernel {iters.cpu().tolist()} plain {iters_r.cpu().tolist()}")
    ok, stalled, line = k2_pcg_verdict(args, active, x, iters, xr, iters_r)
    if line is not None:
        print(f"K2 pcg ({what}): {line}; max|kernel - plain| on the other lanes "
              f"{float(lane_max_abs(x - xr)[~stalled].max()) if bool((~stalled).any()) else 0.0:.3e}")
    if not ok:
        raise AssertionError(f"K2 PCG disagrees with its plain version ({what}): {err}, iterations "
                             f"{iters.cpu().tolist()} against {iters_r.cpu().tolist()}")
    return x, iters, err, xr, iters_r


def k2_f64_check(what, args, active):
    """K2 on an ill-conditioned system, run for a fixed budget (args' tol
    < 0): within K2_TOL of its plain version over K2_SHORT iterations, and
    over the budget no farther from a float64 run of the plain version
    than K2_RATIO times the plain version is (K2_SHORT's note)."""
    import torch

    from mpsfm_tpu_torch.integration import bini_fused

    st, b, dg, z, budget, tol = args
    k2_pcg_check(f"{what}, {K2_SHORT} iterations", (st, b, dg, z, min(K2_SHORT, budget), tol), active)
    x, _ = bini_fused.pcg(*args, active)
    xr, _ = bini_fused.pcg_plain(*args, active)
    x64, _ = bini_fused.pcg_plain(bini_fused.Stencil(*(t.double() for t in st)), b.double(), dg.double(),
                                  z.double(), budget, tol, active)
    err = float((x - xr).abs().max())
    d_k, d_p = float((x.double() - x64).abs().max()), float((xr.double() - x64).abs().max())
    line = (f"K2 pcg ({what}, {budget} iterations): max|kernel - plain| = {err:.3e}; from the float64 run kernel "
            f"{d_k:.3e}, plain {d_p:.3e} (the kernel's within {K2_RATIO}x the plain version's + {K2_TOL})")
    print(line)
    if not (bool(torch.isfinite(x).all()) and d_k <= K2_RATIO * d_p + K2_TOL):
        raise AssertionError(f"K2 PCG farther from the float64 run than its plain version: {line}")
    return x, err


def k2_floor_ms(dev, B, cpl, iters=200):
    """Time per iteration of K2's PCG at B lanes of cpl CTAs each with one
    pixel a thread (16 rows of PCG_THREADS cpl / 16 pixels a lane, a random
    diagonally dominant stencil, fixed budget): the design's own floor, its
    two lane barriers and its reads of partials and halo with almost no
    arithmetic."""
    import torch

    from mpsfm_tpu_torch.integration import bini_fused

    g = torch.Generator(device=dev).manual_seed(SEED)
    shape = (B, 16, bini_fused.PCG_THREADS // 16 * cpl)
    ex, ey, pa, b, x0 = (torch.rand(shape, device=dev, generator=g) for _ in range(5))
    ex[..., -1] = 0.0  # the stencil's border: no edge beyond the last column and row
    ey[..., -1, :] = 0.0
    st = bini_fused.Stencil(ex, ey, pa + 1.0)
    dg = bini_fused.diag(st)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    if len(bini_fused.plan_groups(B, shape[1] * shape[2], B * cpl)) != 1:
        raise AssertionError("the floor's lanes do not fit one group")
    with k2_card_holds(B * cpl):
        return cuda_ms(lambda: bini_fused.pcg(st, b, dg, x0, iters, -1.0, active), 3) / iters


def k2_phase(dev, inputs):
    """K2 vs its plain version at the main path's shapes: the PCG core on
    the first IRLS round's operator (tolerance and budget of the main
    path; run-to-run identity; B = 16 as two lane groups; an oversized grid
    refused), and the fixed-budget solve (BiniParams(max_iter=10,
    cg_max_iter=1000), clamped to 500 CG iterations). Times per solve and
    per CG iteration, and the design's floor."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.integration import bini, bini_fused

    from mpsfm_tpu_torch.ba.covariance import point_covariances

    pr = inputs.priors
    anch, prev, pairs = lane_state(pr, dev)
    cov = point_covariances(convert.ba_data(inputs.ba, device=dev))
    inp = bini._unpack(bini._assemble_batch_anchors(anch, cov, pairs))
    p = bini.BiniParams(**MAIN_BINI)
    wx, wy = bini_fused.weights(inp.z0, p.k)
    st, b, dg = bini._operator(inp, p, wx, wy)
    Bn, H, W = inp.z0.shape
    args = (st, b, dg, inp.z0, p.cg_max_iter, p.cg_tol)
    active = torch.ones(Bn, dtype=torch.bool, device=dev)
    cap = bini_fused._capacity(inp.z0.device.index, W)
    groups = bini_fused.plan_groups(Bn, H * W, cap)
    print(f"K2 pcg plan: {cap} co-resident CTAs of {bini_fused.PCG_THREADS} threads; B = {Bn}: {groups}")
    x, iters, err, xr, iters_r = k2_pcg_check(f"main path, tol {p.cg_tol}", args, active)
    its = iters.cpu().tolist()
    x2, iters2 = bini_fused.pcg(*args, active)
    if not (torch.equal(x2, x) and torch.equal(iters2, iters)):
        raise AssertionError("K2 PCG is not bit-identical from run to run")
    print("K2 pcg run to run: x and iterations bit-identical")

    # B = 2 Bn: the second half starts from a noisier z0; the planner makes two groups
    noise = torch.randn(inp.z0.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    args16 = (bini_fused.Stencil(*(torch.cat([f, f]) for f in st)), torch.cat([b, b]), torch.cat([dg, dg]),
              torch.cat([inp.z0, inp.z0 + 0.01 * noise]), p.cg_max_iter, p.cg_tol)
    active16 = torch.ones(2 * Bn, dtype=torch.bool, device=dev)
    groups16 = bini_fused.plan_groups(2 * Bn, H * W, cap)
    n0 = bini_fused.KERNEL.launches
    x16, _, err16, _, _ = k2_pcg_check(f"B = {2 * Bn}, {len(groups16)} lane groups", args16, active16)
    if len(groups16) < 2 or bini_fused.KERNEL.launches - n0 != len(groups16):
        raise AssertionError(f"K2 at B = {2 * Bn}: {bini_fused.KERNEL.launches - n0} launches for {groups16}")
    if groups16[0] == groups[0]:  # the same lanes on the same CTAs
        if not torch.equal(x16[:Bn], x):
            raise AssertionError("K2's first lane group at B = 16 differs from the same lanes at B = 8")
        print(f"K2 pcg B = {2 * Bn}: first group bit-identical to the B = {Bn} run")

    too_many = Bn * -(-H * W // bini_fused.PCG_THREADS)  # one pixel a thread: more CTAs than the card holds
    try:
        with k2_card_holds(too_many):
            bini_fused.pcg(*args, active)
    except RuntimeError as e:
        print(f"K2 pcg on {too_many} CTAs: refused ({e})")
    else:
        raise AssertionError(f"K2's cooperative launch of {too_many} CTAs was not refused")

    ms = cuda_ms(lambda: bini_fused.pcg(*args, active), 5)
    plain_ms = cuda_ms(lambda: bini_fused.pcg_plain(*args, active), 1)
    floor_iter = k2_floor_ms(dev, Bn, groups[0].cpl)
    print(f"K2 pcg: {ms:.4f} ms per solve, {1e3 * ms / max(its):.3f} us per CG iteration ({max(its)} iterations); "
          f"design floor {1e3 * floor_iter:.3f} us per iteration ({floor_iter * max(its):.4f} ms per solve)")
    err = max(err, err16)
    flops = 26.0 * H * W * sum(its)  # per pixel-iteration: stencil 15, three dots 6, updates 5
    nbytes = 4.0 * 7 * Bn * H * W  # ex, ey, pa, b, diag, x0 read once; x written once

    pf = bini.BiniParams(max_iter=10, cg_max_iter=1000)
    zf = bini_fused.bini_solve_fused(inp, pf)
    zr = bini_fused.bini_solve_fused_plain(inp, pf)
    err_f = float((zf - zr).abs().max())
    print(f"K2 bini_solve_fused (10 x {min(pf.cg_max_iter, bini_fused.PALLAS_CG_CAP)} CG, B={Bn} {H}x{W}): "
          f"max|kernel - plain| = {err_f:.3e} (tolerance {K2_TOL}); max|z - z0| {float((zr - inp.z0).abs().max()):.3e}")
    if not err_f <= K2_TOL:
        raise AssertionError(f"K2 fixed-budget solve disagrees with its plain version: {err_f}")

    # the same two checks must fail a kernel with a faulty halo at the seams of
    # one CTA a lane; the middle CTA's seams fall mid-row (W does not divide chunk)
    g0 = groups[0]
    cta, passed = g0.cpl // 2, []
    for kind in ("stale", "dropped"):
        with k2_seam_fault(kind, bini_fused.PCG_THREADS * g0.ppt, cta):
            xf, itf = bini_fused.pcg_plain(*args, active)
            zff = bini_fused.bini_solve_fused_plain(inp, pf)
        e_pcg, gap = float((xf - xr).abs().max()), int((itf - iters_r).abs().max())
        e_fix = float((zff - zr).abs().max())
        print(f"K2 checks vs a {kind} halo at CTA {cta}'s seams: PCG max|Δx| {e_pcg:.3e}, iterations up to "
              f"{gap} apart; fixed budget max|Δz| {e_fix:.3e} (tolerance {K2_TOL})")
        if (e_pcg <= K2_TOL and gap <= 1) or e_fix <= K2_TOL:
            passed.append(kind)
    if passed:
        raise AssertionError(f"K2's checks would pass a kernel with a {passed} halo at one seam")
    f_ms = cuda_ms(lambda: bini_fused.bini_solve_fused(inp, pf), 1)
    f_plain_ms = cuda_ms(lambda: bini_fused.bini_solve_fused_plain(inp, pf), 1)
    print(f"K2 bini_solve_fused: kernel {f_ms:.3f} ms, plain {f_plain_ms:.3f} ms")
    return dict(err=max(err, err_f), ms=ms, plain_ms=plain_ms, library_ms=None,
                ops_ms=flops / PEAK_F32 * 1e3, bytes_ms=nbytes / PEAK_BYTES * 1e3)


PLANE = dict(normal=(0.1, -0.05, 1.0), offset=4.5)  # the world plane n·X = offset of the consistent scenes


def plane_depth(bundle, c, rays):
    """Depth along rays (..., 3) (camera coordinates with z = 1) of the
    bundle's camera c to the world plane PLANE."""
    n = np.asarray(PLANE["normal"]) / np.linalg.norm(PLANE["normal"])
    R = _rotmat(bundle.quat[c].astype(np.float64))
    center = -R.T @ bundle.t[c].astype(np.float64)
    return (PLANE["offset"] - n @ center) / (rays @ (R @ n))  # X = center + d Rᵀ ray on the plane


def plane_depths(bundle, cams, H, W):
    """The depth maps (len(cams), H, W) of the plane PLANE rendered exactly
    into the bundle's cameras `cams` on an H×W grid."""
    K = grid_K(H, W).astype(np.float64)
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    rays = np.stack([(xx - K[0, 2]) / K[0, 0], (yy - K[1, 2]) / K[1, 1], np.ones_like(xx)], -1)
    return np.stack([plane_depth(bundle, c, rays) for c in cams]).astype(np.float32)


def dc_phase(dev, bundle, H, W, shift=1.5):
    """The depth-consistency check on a consistent scene at the main path's
    grid: one world plane rendered exactly into 6 of the bundle's cameras
    (the main path's lanes 0-5), variances (5% of the depth)² ÷
    prior_std_multiplier², the query lane 0 against lanes 1-5. The score
    must stay below depth_cons_thresh, and exceed it once lane 1's depth is
    shifted by `shift` (tests/test_mapper_units.py's make_dc_rec). Returns
    (score, shifted score, wall ms of one check)."""
    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.mapper.depth_consistency import _bundle_counts, bundle_score

    cams = np.linspace(0, bundle.quat.shape[0] - 1, 8).round().astype(int)[:6]
    depth = plane_depths(bundle, cams, H, W)
    var = ((depth * 0.05) ** 2).astype(np.float32) / np.float32(DC["psm"] ** 2)
    K = grid_K(H, W)
    images = [(depth[i], var[i], K, bundle.quat[c], bundle.t[c]) for i, c in enumerate(cams)]

    def score(imgs):
        args = convert.dc_inputs(imgs[0], imgs[1:], device=dev)
        return bundle_score(_bundle_counts(*args, DC["c"], DC["valid_thresh"]))

    score(images)  # warm-up
    t = time.perf_counter()
    s0 = score(images)
    ms = (time.perf_counter() - t) * 1e3
    shifted = list(images)
    shifted[1] = (depth[1] + np.float32(shift), *images[1][1:])
    s1 = score(shifted)
    line = (f"depth consistency on a plane seen by cameras {cams.tolist()} at {H}x{W}: score {s0:.4f}, "
            f"with lane 1's depth +{shift}: {s1:.4f} (threshold {DC['score_thresh']}); one check of 5 refs "
            f"{ms:.2f} ms wall")
    print(line)
    if not (s0 < DC["score_thresh"] < s1):
        raise AssertionError(f"depth consistency: {line}")
    return s0, s1, ms


def two_view_scene(bundle, cams, rng, n=TWO_VIEW_MATCHES):
    """Every pair of the bundle's cameras `cams`: n matches of points seen by
    both (pixels uniform in the first image, depth uniform in [4, 8]), with
    NOISE_PX of Gaussian noise and the first OUTLIERS·n second keypoints
    replaced by random pixels. Returns (pairs for
    estimate_two_view_geometry_batch, true (R, unit t) of cam2_from_cam1)."""
    cam = SimpleNamespace(fx=FOCAL, fy=FOCAL, cx=IMG_W / 2, cy=IMG_H / 2)
    wh = np.array([IMG_W, IMG_H])
    pairs, truth = [], []
    for i, c1 in enumerate(cams):
        for c2 in cams[i + 1:]:
            X = np.zeros((0, 3))
            while len(X) < n:
                px = rng.uniform(0, wh, size=(4 * n, 2))
                Xw = _lift(bundle, c1, px, rng.uniform(4.0, 8.0, 4 * n))
                p2, z2 = _project(bundle, c2, Xw)
                X = np.concatenate([X, Xw[(z2 > 0.1) & (p2 >= 0).all(-1) & (p2 < wh).all(-1)]])
            X = X[:n]
            k1 = _project(bundle, c1, X)[0] + rng.normal(scale=NOISE_PX, size=(n, 2))
            k2 = _project(bundle, c2, X)[0] + rng.normal(scale=NOISE_PX, size=(n, 2))
            k2[:int(OUTLIERS * n)] = rng.uniform(0, wh, size=(int(OUTLIERS * n), 2))
            pairs.append((cam, cam, k1, k2, np.stack([np.arange(n)] * 2, -1)))
            R1, R2 = _rotmat(bundle.quat[c1]), _rotmat(bundle.quat[c2])
            R = R2 @ R1.T
            t = bundle.t[c2] - R @ bundle.t[c1]
            truth.append((R, t / np.linalg.norm(t)))
    return pairs, truth


def pnp_scene(bundle, c, rng, planar, n=PNP_MATCHES):
    """n 2D-3D matches of the bundle's camera c: points at pixels uniform in
    the image, at depths uniform in [4, 8] or on one world plane, NOISE_PX of
    noise on the keypoints, the first OUTLIERS·n keypoints random. Returns
    (xyz (n, 3), normalized keypoints (n, 2)), float32."""
    wh = np.array([IMG_W, IMG_H])
    px = rng.uniform(0, wh, size=(n, 2))
    if planar:
        d = plane_depth(bundle, c, np.concatenate([(px - wh / 2) / FOCAL, np.ones((n, 1))], -1))
    else:
        d = rng.uniform(4.0, 8.0, n)
    X = _lift(bundle, c, px, d)
    kp = _project(bundle, c, X)[0] + rng.normal(scale=NOISE_PX, size=(n, 2))
    kp[:int(OUTLIERS * n)] = rng.uniform(0, wh, size=(int(OUTLIERS * n), 2))
    return X.astype(np.float32), ((kp - wh / 2) / FOCAL).astype(np.float32)


def _lift(bundle, c, px, d):
    R, t = _rotmat(bundle.quat[c]), bundle.t[c]
    xc = np.stack([(px[:, 0] - IMG_W / 2) / FOCAL * d, (px[:, 1] - IMG_H / 2) / FOCAL * d, d], -1)
    return (xc - t) @ R


def _project(bundle, c, X):
    p = X @ _rotmat(bundle.quat[c]).T + bundle.t[c]
    return p[:, :2] / p[:, 2:] * FOCAL + np.array([IMG_W / 2, IMG_H / 2]), p[:, 2]


def _angle_deg(R1, R2):
    return float(np.rad2deg(np.arccos(np.clip((np.trace(R1 @ R2.T) - 1) / 2, -1.0, 1.0))))


def _dir_deg(a, b):
    return float(np.rad2deg(np.arccos(np.clip(a @ b / np.linalg.norm(a) / np.linalg.norm(b), -1.0, 1.0))))


def library_solvers(dev, n):
    """Times of the library solvers behind two-view verification at its
    shapes: the complete QR of the n transposed minimal systems (9×8) of the
    essential or the homography hypotheses, and the batched eigh of 3×3
    matrices at EIGH_CHUNK; and whether the library takes 2·EIGH_CHUNK in
    one call (cuSOLVER 12.8 refuses it, so geometry.linalg.eigh chunks)."""
    import torch

    from mpsfm_tpu_torch.geometry.linalg import EIGH_CHUNK

    g = torch.Generator(device=dev).manual_seed(SEED)
    A = torch.randn(n, 9, 8, device=dev, generator=g)
    qr_ms = cuda_ms(lambda: torch.linalg.qr(A, mode="complete"), 1)
    M = torch.randn(2 * EIGH_CHUNK, 3, 3, device=dev, generator=g)
    S = M @ M.transpose(-1, -2)
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(S[:EIGH_CHUNK]), 3)
    try:
        torch.linalg.eigh(S)
        torch.cuda.synchronize()
        big = "taken"
    except RuntimeError as e:
        big = f"refused ({str(e)[:60]})"
    print(f"library solvers: torch.linalg.qr(mode='complete') of {n} 9x8 matrices {qr_ms:.1f} ms; torch.linalg.eigh "
          f"of {EIGH_CHUNK} 3x3 matrices {eigh_ms:.3f} ms; of {2 * EIGH_CHUNK} in one call: {big}")


def estimators_phase(dev, bundle, rng):
    """Two-view verification of the 66 pairs of TWO_VIEW_CAMS of the
    bundle's cameras and PnP of camera 6 on points in general position and
    on one plane, with the mapper's budget of NUM_HYP hypotheses, through
    the port's entry points on the card (wall time after a warm-up), against
    the truth and against the CPU with the same samples. Returns a dict of
    the wall times."""
    import torch

    from mpsfm_tpu_torch.estimators.ransac import ransac_pnp, sample_indices
    from mpsfm_tpu_torch.estimators.two_view import (
        TwoViewConfig,
        _estimate_pair,
        estimate_two_view_geometry_batch,
    )

    n_out = int(OUTLIERS * TWO_VIEW_MATCHES)
    pairs, truth = two_view_scene(bundle, np.arange(TWO_VIEW_CAMS), rng)
    gen = torch.Generator().manual_seed(SEED)  # on the CPU: the same samples for the card and the CPU
    valid = torch.ones(TWO_VIEW_MATCHES, dtype=torch.bool)
    idx = [(sample_indices(gen, NUM_HYP, 8, valid), sample_indices(gen, NUM_HYP, 4, valid)) for _ in pairs]
    estimate_two_view_geometry_batch(pairs, MAX_ERROR_PX, NUM_HYP, indices=idx, device=dev)  # warm-up
    t = time.perf_counter()
    tvg = estimate_two_view_geometry_batch(pairs, MAX_ERROR_PX, NUM_HYP, indices=idx, device=dev)
    times = {"two_view_ms": (time.perf_counter() - t) * 1e3}
    rot = np.array([_angle_deg(_rotmat(g.pose.quat.astype(np.float64)), R) for g, (R, _) in zip(tvg, truth)])
    tra = np.array([_dir_deg(g.pose.t.astype(np.float64), tt) for g, (_, tt) in zip(tvg, truth)])
    recall = np.array([(g.inlier_matches[:, 0] >= n_out).sum() / (TWO_VIEW_MATCHES - n_out) for g in tvg])
    configs = [g.config for g in tvg]
    strict = int(((rot <= 1.0) & (tra <= 2.0) & (recall >= 0.9)).sum())
    line = (f"two-view verification, {len(pairs)} pairs x {TWO_VIEW_MATCHES} matches ({NOISE_PX} px noise, "
            f"{OUTLIERS:.0%} outliers), {NUM_HYP} hypotheses: {times['two_view_ms']:.1f} ms wall; "
            f"{configs.count(TwoViewConfig.CALIBRATED)} CALIBRATED; rotation error median {np.median(rot):.3f} max "
            f"{rot.max():.3f} deg, translation direction median {np.median(tra):.3f} max {tra.max():.3f} deg, "
            f"true-inlier recall median {np.median(recall):.4f} min {recall.min():.4f}; "
            f"{strict} pairs within 1 deg, 2 deg and 90%")
    print(line)
    # every pair CALIBRATED; the median pair within 1 deg, 2 deg and 90% of the true inliers; no
    # pair off by more than 5 deg of rotation or below half the true inliers (a fixed budget with
    # one local refit, as the JAX package's, misses the per-pair bounds on some pairs: PERF.md)
    if not (all(c == TwoViewConfig.CALIBRATED for c in configs) and np.median(rot) <= 1.0
            and np.median(tra) <= 2.0 and np.median(recall) >= 0.9 and rot.max() <= 5.0 and recall.min() >= 0.5):
        raise AssertionError(f"two-view verification against the truth: {line}")

    library_solvers(dev, len(pairs) * NUM_HYP)

    # card vs CPU on the same samples, through the batched core (which returns the winning hypothesis)
    xy = [torch.as_tensor(np.stack([(p[k] - [IMG_W / 2, IMG_H / 2]) / FOCAL for p in pairs]), dtype=torch.float32)
          for k in (2, 3)]
    thr = torch.full((len(pairs),), (MAX_ERROR_PX / FOCAL) ** 2)
    core = [torch.stack([i[k] for i in idx]) for k in (0, 1)]
    vmask = torch.ones(len(pairs), TWO_VIEW_MATCHES, dtype=torch.bool)
    outs = [_estimate_pair(*(a.to(d) for a in (*core, *xy, vmask, thr, thr))) for d in (dev, "cpu")]
    g, c = ({k: (v.cpu() if torch.is_tensor(v) else type(v)(*(f.cpu() for f in v))) for k, v in o.items()} for o in outs)
    same = g["best"] == c["best"]
    n_gap = float(((g["num_inliers"] - c["num_inliers"]).abs() / c["num_inliers"]).max())
    pose_gap = max([float((g["pose"][k] - c["pose"][k])[same].abs().max()) for k in (0, 1) if same.any()] + [0.0])
    line = (f"two-view card vs CPU, same samples: configs {'equal' if torch.equal(g['config'], c['config']) else 'DIFFER'}, "
            f"best hypothesis the same on {int(same.sum())} of {len(pairs)} pairs, inlier counts within "
            f"{n_gap:.4%} (tolerance 1%), poses within {pose_gap:.3e} where the best is the same (tolerance 1e-3)")
    print(line)
    if not (torch.equal(g["config"], c["config"]) and n_gap <= 0.01 and pose_gap <= 1e-3):
        raise AssertionError(line)

    cam = 6
    Rt, tt = _rotmat(bundle.quat[cam]), bundle.t[cam].astype(np.float64)
    baseline = float(np.linalg.norm(Rt.T @ tt - _rotmat(bundle.quat[0]).T @ bundle.t[0]))  # centres of cameras 6 and 0
    n_out = int(OUTLIERS * PNP_MATCHES)
    for planar in (False, True):
        xyz, xyn = pnp_scene(bundle, cam, rng, planar)
        valid = torch.ones(PNP_MATCHES, dtype=torch.bool)
        pidx = sample_indices(torch.Generator().manual_seed(SEED), NUM_HYP, 6, valid)
        args = {d: [torch.as_tensor(a, device=d) for a in (pidx, xyz, xyn, valid)] + [(MAX_ERROR_PX / FOCAL) ** 2]
                for d in (dev, "cpu")}
        ransac_pnp(*args[dev])  # warm-up
        t = time.perf_counter()
        o = ransac_pnp(*args[dev])
        int(o["num_inliers"])
        what = "coplanar" if planar else "general"
        times[f"pnp_{what}_ms"] = (time.perf_counter() - t) * 1e3
        oc = ransac_pnp(*args["cpu"])
        rot_err = _angle_deg(_rotmat(o["pose"].quat.cpu().double().numpy()), Rt)
        t_err = float(np.linalg.norm(o["pose"].t.cpu().double().numpy() - tt))
        rec = float(o["inlier_mask"].cpu()[n_out:].double().mean())
        n_gap = abs(int(o["num_inliers"]) - int(oc["num_inliers"])) / int(oc["num_inliers"])
        pose_gap = max(float((o["pose"].quat.cpu() - oc["pose"].quat).abs().max()),
                       float((o["pose"].t.cpu() - oc["pose"].t).abs().max()))
        same = int(o["best"]) == int(oc["best"])
        line = (f"PnP ({what} points), {PNP_MATCHES} matches, {NUM_HYP} samples x 2 hypotheses: "
                f"{times[f'pnp_{what}_ms']:.1f} ms wall; rotation error {rot_err:.4f} deg, |Δt| {t_err:.4g} "
                f"({t_err / baseline:.3%} of the baseline {baseline:.3f}), true-inlier recall {rec:.4f}; card vs CPU: "
                f"best {'the same' if same else 'DIFFERENT'}, inliers within {n_gap:.3%}, poses within {pose_gap:.3e}")
        print(line)
        if not (rot_err <= 1.0 and t_err <= 0.01 * baseline and rec >= 0.9 and n_gap <= 0.01
                and (pose_gap <= 1e-3 or not same)):
            raise AssertionError(line)
    return times


def scene_reconstruction(bundle, cams, quat, t):
    """A port Reconstruction of the bundle's cameras `cams`: one 640×480
    HostCamera; image c's keypoints are its observations (r_uv, keypoint k
    of every image sees point k), registered at pose (quat[c], t[c]),
    cam_from_world. No point yet."""
    from mpsfm_tpu_torch.scene.reconstruction import HostCamera, ImageRecord, Pose, Reconstruction

    P = bundle.xyz.shape[0]
    rec = Reconstruction()
    rec.add_camera(HostCamera(1, np.array([FOCAL, FOCAL, IMG_W / 2, IMG_H / 2]), int(IMG_W), int(IMG_H)))
    for c in cams:
        im = ImageRecord(int(c), f"im{int(c):03d}.jpg", 1)
        im.keypoints = bundle.r_uv[c * P:(c + 1) * P].astype(np.float64)
        im.point3D_ids = np.full(P, -1, np.int64)
        q = np.asarray(quat[c], np.float64)
        im.pose = Pose(q / np.linalg.norm(q), np.asarray(t[c], np.float64))
        im.registered = True
        rec.add_image(im)
    return rec


def scene_invariants(rec, what):
    """The pool and the images agree: the observation table holds alive
    points only, each observation is its image's point3D_ids entry, and the
    observation count equals the track lengths' sum and the images' count
    of assigned keypoints. Returns the observation count."""
    o_pid, o_im, o_kp = rec.observations()
    alive = rec.point_ids()
    held = sum(int((im.point3D_ids >= 0).sum()) for im in rec.images.values())
    ok = (len(o_pid) == int(rec.track_len[alive].sum()) == held and rec.num_points3D() == len(alive)
          and bool(rec.alive[o_pid].all())
          and all(np.array_equal(rec.images[int(i)].point3D_ids[o_kp[o_im == i]], o_pid[o_im == i])
                  for i in np.unique(o_im)))
    if not ok:
        raise AssertionError(f"scene state after {what}: {len(o_pid)} observations, track lengths sum to "
                             f"{int(rec.track_len[alive].sum())}, {held} keypoints hold a point")
    return len(o_pid)


def scene_state_phase(bundle, quat, t, xyz, rng):
    """(a) The scene state at the bench bundle's size: every point with a
    track through every image, then the passes of the mapper's host state,
    each timed on the host clock; invariants after each. Returns the times."""
    C, P = quat.shape[0], xyz.shape[0]
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        times[name] = time.perf_counter() - t0
        return r

    rec = timed("images", lambda: scene_reconstruction(bundle, range(C), quat, t))
    pids = timed("add_points", lambda: [rec.add_point3D(xyz[k], [(c, k) for c in range(C)]) for k in range(P)])
    if pids != list(range(P)) or scene_invariants(rec, "adding the points") != C * P:
        raise AssertionError(f"adding {P} points of {C} observations each")
    obs = timed("observations", rec.observations)
    if len(obs[0]) != C * P:
        raise AssertionError(f"observations: {len(obs[0])}, not {C * P}")
    ang = timed("triangulation_angles", lambda: rec.triangulation_angles(rec.point_ids()))
    if not (np.isfinite(ang).all() and (ang > 0).all()):
        raise AssertionError("a triangulation angle is not finite and positive")
    changed = timed("filter_points3D", lambda: rec.filter_points3D(*SCENE_FILTER, rec.point_ids()))
    n_filtered = scene_invariants(rec, "filter_points3D")
    local = timed("find_local_bundle_ids", lambda: rec.find_local_bundle_ids(0))
    if len(local) != 5 or 0 in local:
        raise AssertionError(f"local bundle of image 0: {local}")
    last = rec.images[C - 1]
    n_last = last.num_points3D()
    dying = int((rec.track_len[last.point3D_ids[last.point3D_ids >= 0]] == 2).sum())  # their other observation goes too
    timed("deregister_image", lambda: rec.deregister_image(C - 1))
    n_obs = scene_invariants(rec, "deregister_image")
    if last.registered or last.num_points3D() or n_obs != n_filtered - n_last - dying:
        raise AssertionError(f"deregistering image {C - 1} ({n_last} observations)")
    alive = rec.point_ids()
    victims = rng.choice(alive, int(SCENE_REDO * len(alive)), replace=False)
    saved = [(rec.xyz[p].copy(), rec.tracks[p]) for p in victims]
    timed("delete_points", lambda: [rec.delete_point3D(int(p)) for p in victims])
    if rec.num_points3D() != len(alive) - len(victims):
        raise AssertionError("deleting points")
    scene_invariants(rec, "delete_point3D")
    new = timed("readd_points", lambda: [rec.add_point3D(x, tr) for x, tr in saved])
    if new != [int(p) for p in victims[::-1]] or scene_invariants(rec, "re-adding") != n_obs:
        raise AssertionError("the re-added points did not take the freed ids, last freed first")
    px0 = rec.project_points_into_image(0, rec.point_ids())[0]
    scale = timed("normalize", rec.normalize)
    px1 = rec.project_points_into_image(0, rec.point_ids())[0]
    gap = float(np.abs(px1 - px0).max())
    if not (np.isfinite(scale) and scale > 0 and gap <= 1e-6):
        raise AssertionError(f"normalize: scale {scale}, pixels moved by {gap}")
    print(f"scene state: {C} images x {P} points, {C * P} observations in the native store; filter_points3D at "
          f"{SCENE_FILTER[0]} px and {SCENE_FILTER[1]} deg changed {changed} observations; triangulation angle median "
          f"{np.median(ang):.2f} deg; local bundle of image 0 {local}; {len(victims)} points deleted and re-added into "
          f"their ids; normalize scale {scale:.4f}, pixels within {gap:.2e}")
    for name, sec in times.items():
        print(f"scene state {name}: {sec:.4f} s wall")
    return times


def store_parity_phase(bundle, quat, t, xyz, cams, seed):
    """(b) The native track store against the plain one (PyTrackStore, put
    in before any point) under the same op sequence on the first `cams`
    images: add every point, filter, deregister an image, delete and re-add
    a tenth of the points, remove and re-add observations. Their xyz,
    alive, track_len, point3D_ids, tracks and observations must be equal.
    Returns the two runs' times."""
    from mpsfm_tpu_torch import native
    from mpsfm_tpu_torch.scene.reconstruction import PyTrackStore

    P = xyz.shape[0]
    recs, times = [], []
    for plain in (False, True):
        rng = np.random.default_rng(seed)
        rec = scene_reconstruction(bundle, range(cams), quat, t)
        if plain:
            rec._store = PyTrackStore()
        t0 = time.perf_counter()
        for k in range(P):
            rec.add_point3D(xyz[k], [(c, k) for c in range(cams)])
        rec.filter_points3D(*SCENE_FILTER, rec.point_ids())
        rec.deregister_image(cams - 1)
        victims = rng.choice(rec.point_ids(), int(SCENE_REDO * rec.num_points3D()), replace=False)
        saved = [(rec.xyz[p].copy(), rec.tracks[p]) for p in victims]
        for p in victims:
            rec.delete_point3D(int(p))
        for x, tr in saved:
            rec.add_point3D(x, tr)
        removed = []
        for p in rng.choice(rec.point_ids(), P // 4, replace=False):
            tr = rec.tracks[p]
            imid, kp = tr[rng.integers(0, len(tr))]
            removed.append((int(p), imid, kp, len(tr) > 2))
            rec.remove_observation(int(p), imid, kp)
        for p, imid, kp, kept in removed:
            if kept:
                rec.add_observation(p, imid, kp)
        times.append(time.perf_counter() - t0)
        recs.append(rec)
    nat, py = recs
    if not isinstance(nat._store, native.NativeTrackStore) or not isinstance(py._store, PyTrackStore):
        raise AssertionError("store parity: the stores are not the native and the plain one")
    same = (np.array_equal(nat.xyz, py.xyz) and np.array_equal(nat.alive, py.alive)
            and np.array_equal(nat.track_len, py.track_len)
            and all(np.array_equal(nat.images[i].point3D_ids, py.images[i].point3D_ids) for i in nat.images)
            and np.array_equal(nat.point_ids(), py.point_ids())
            and all(nat.tracks[p] == py.tracks[p] for p in nat.point_ids())
            and all(np.array_equal(a, b) for a, b in zip(nat.observations(), py.observations())))
    line = (f"track store, native vs plain (PyTrackStore), {cams} images x {P} points, the same op sequence: "
            f"{'equal' if same else 'DIFFERENT'} state ({nat.num_points3D()} points, "
            f"{len(nat.observations()[0])} observations)")
    print(line)
    print(f"track store op sequence, native: {times[0]:.4f} s wall")
    print(f"track store op sequence, plain: {times[1]:.4f} s wall")
    if not same:
        raise AssertionError(line)
    return times


@contextlib.contextmanager
def fixed_draws(indices):
    """Correspondences.populate verifies with the given RANSAC samples (a
    list, per pair, of (idx_e, idx_h)) in place of its device's generator's."""
    import mpsfm_tpu_torch.scene.correspondences as corr

    estimate = corr.estimate_two_view_geometry_batch
    corr.estimate_two_view_geometry_batch = lambda pairs, **kw: estimate(pairs, indices=indices, **kw)
    try:
        yield
    finally:
        corr.estimate_two_view_geometry_batch = estimate


def verification_phase(dev, bundle, rng, cams=TWO_VIEW_CAMS, n=TWO_VIEW_MATCHES):
    """(c) Geometric verification through Correspondences.populate on `dev`
    for the first `cams` cameras: keypoints are the bundle's observations;
    each pair gets n matches of shared points, OUTLIERS of them with the
    second image's keypoint id replaced by a random one. Wall time after a
    warm-up. Held: every pair CALIBRATED, the median pair within 1 deg of
    rotation and 90% of the true inliers, the correspondence graph equal to
    each pair's inlier matches and inlier_match_scores to their counts; and
    populate on `dev` against populate on the CPU with the same samples:
    the same configs, inlier counts within 1%. The translation direction
    and the worst pair are printed, not held: on these points the
    reference's algorithm (one local refit of a fixed budget) misses
    estimators_phase's per-pair bounds, as the JAX package does on the
    same samples (PERF.md). Returns the wall seconds."""
    import torch

    from mpsfm_tpu_torch.estimators.ransac import sample_indices
    from mpsfm_tpu_torch.estimators.two_view import TwoViewConfig
    from mpsfm_tpu_torch.scene.correspondences import Correspondences

    P = bundle.xyz.shape[0]
    rec = scene_reconstruction(bundle, range(cams), bundle.quat, bundle.t)
    names = {c: rec.images[c].name for c in range(cams)}
    keypoints = {names[c]: rec.images[c].keypoints for c in range(cams)}
    matches, truth = {}, {}
    for i in range(cams):
        for j in range(i + 1, cams):
            ids = rng.choice(P, n, replace=False)
            m = np.stack([ids, ids], -1)
            n_out = int(OUTLIERS * n)
            m[:n_out, 1] = rng.integers(0, P, n_out)
            matches[(names[i], names[j])] = m
            R1, R2 = _rotmat(bundle.quat[i]), _rotmat(bundle.quat[j])
            R = R2 @ R1.T
            tt = bundle.t[j] - R @ bundle.t[i]
            truth[(i, j)] = (R, tt / np.linalg.norm(tt))
    Correspondences({}, rec, device=dev).populate(keypoints, matches)  # warm-up
    corr = Correspondences({}, rec, device=dev)
    t0 = time.perf_counter()
    corr.populate(keypoints, matches)
    wall = time.perf_counter() - t0
    pairs = corr.image_pairs()
    rot, tra, recall, configs, graph_ok = [], [], [], [], True
    for (i, j) in pairs:
        g = corr.two_view_geom_by_ids(i, j)
        m = matches[(names[i], names[j])]
        R, tt = truth[(i, j)]
        rot.append(_angle_deg(_rotmat(np.asarray(g.pose.quat, np.float64)), R))
        tra.append(_dir_deg(np.asarray(g.pose.t, np.float64), tt))
        inl = g.inlier_matches
        recall.append((inl[:, 0] == inl[:, 1]).sum() / (m[:, 0] == m[:, 1]).sum())
        configs.append(g.config)
        graph_ok &= (np.array_equal(corr.matches(i, j), inl)
                     and corr.inlier_match_scores[frozenset((i, j))] == float(len(inl)))
    rot, tra, recall = map(np.array, (rot, tra, recall))
    line = (f"geometric verification, Correspondences.populate on {dev}: {len(pairs)} pairs of {cams} images x {n} "
            f"matches ({OUTLIERS:.0%} outliers), {configs.count(TwoViewConfig.CALIBRATED)} CALIBRATED; rotation "
            f"error median {np.median(rot):.3f} max {rot.max():.3f} deg, translation direction median "
            f"{np.median(tra):.3f} max {tra.max():.3f} deg, true-inlier recall median {np.median(recall):.4f} min "
            f"{recall.min():.4f}; {int(((rot <= 1.0) & (tra <= 2.0) & (recall >= 0.9)).sum())} pairs within 1 deg, "
            f"2 deg and 90%; correspondence graph {'holds' if graph_ok else 'DIFFERS FROM'} the inlier matches and "
            f"scores")
    print(line)
    print(f"geometric verification (populate, {len(pairs)} pairs): {wall:.4f} s wall")
    if not (len(pairs) == cams * (cams - 1) // 2 and graph_ok and corr.cg.finalized
            and all(c == TwoViewConfig.CALIBRATED for c in configs) and np.median(rot) <= 1.0
            and np.median(recall) >= 0.9):
        raise AssertionError(f"geometric verification: {line}")

    gen = torch.Generator().manual_seed(SEED)  # on the CPU: the same samples for both devices
    valid = torch.ones(n, dtype=torch.bool)
    idx = [(sample_indices(gen, NUM_HYP, 8, valid), sample_indices(gen, NUM_HYP, 4, valid)) for _ in matches]
    runs = [Correspondences({}, rec, device=d) for d in (dev, "cpu")]
    with fixed_draws(idx):
        for r in runs:
            r.populate(keypoints, matches)
    g, c = ([r.two_view_geom_by_ids(*p) for p in pairs] for r in runs)
    same_config = all(a.config == b.config for a, b in zip(g, c))
    n_gap = max(abs(a.num_inliers - b.num_inliers) / b.num_inliers for a, b in zip(g, c))
    same_inl = sum(np.array_equal(a.inlier_matches, b.inlier_matches) for a, b in zip(g, c))
    line = (f"geometric verification, populate on {dev} vs the CPU with the same samples: configs "
            f"{'equal' if same_config else 'DIFFER'}, inlier counts within {n_gap:.4%} (tolerance 1%), the same "
            f"inlier matches on {same_inl} of {len(pairs)} pairs")
    print(line)
    if not (same_config and n_gap <= 0.01):
        raise AssertionError(line)
    return wall


def cov_store_phase(cov):
    """(d) The point covariances' store (LazyCovDict) with the card's
    tensor: device_view() hands back that same tensor without a host read,
    a pop reads nothing either, and every point_covs[pid] then equals the
    tensor's row read to the host. Returns the first host access's wall
    seconds (the one read)."""
    from mpsfm_tpu_torch.scene.reconstruction import LazyCovDict

    P = cov.shape[0]
    point_covs = LazyCovDict()
    point_covs.set_pending(cov, np.arange(P))
    view = point_covs.device_view()
    slots = point_covs.slots_for(np.arange(P))
    point_covs.pop(7, None)  # a deleted point, as Reconstruction._clear_slot pops it
    unread = bool(point_covs._pendings)
    t0 = time.perf_counter()
    n = len(point_covs)  # the first host access: one read of the tensor
    read_s = time.perf_counter() - t0
    ref = cov.cpu().double().numpy()
    keep = np.arange(P) != 7
    host = np.stack([point_covs[int(p)] for p in np.flatnonzero(keep)])
    ok = (view[0] is cov and view[0].device == cov.device and np.array_equal(slots, np.arange(P)) and unread
          and n == P - 1 and 7 not in point_covs and np.array_equal(host, ref[keep]))
    line = (f"point covariances' store: {P} covariances on {cov.device} parked; device_view the same tensor, no host "
            f"read before the first access; {'every entry equal to' if ok else 'DIFFERENT from'} the tensor's rows")
    print(line)
    print(f"point covariances' store, first host access (one read of {P}x3x3): {read_s:.4f} s wall")
    if not ok:
        raise AssertionError(line)
    return read_s


def scene_phase(dev, bundle, out, rng, cams=TWO_VIEW_CAMS, n_matches=TWO_VIEW_MATCHES):
    """The scene's host state (slice 5a): (a) a Reconstruction of the bundle
    at the main path's refined poses and points, (b) the native store
    against the plain one, (c) geometric verification through
    Correspondences.populate on `dev`, (d) the covariance store with the
    main path's covariances. Returns a dict of the wall times."""
    quat, t, xyz = (out[k].cpu().double().numpy() for k in ("quat", "t", "xyz"))
    times = {f"scene_{k}_s": v for k, v in scene_state_phase(bundle, quat, t, xyz, rng).items()}
    times["store_native_s"], times["store_plain_s"] = store_parity_phase(bundle, quat, t, xyz, cams, SEED + 3)
    times["populate_s"] = verification_phase(dev, bundle, rng, cams, n_matches)
    times["cov_read_s"] = cov_store_phase(out["cov"])
    return times


# ---- the scene refinement phase (slices 5b and the front of 6a) ----

def bench_points(n_pts, seed=SEED):
    """The bench bundle's true points (synthetic_bundle's first draws,
    before their noise)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(4, 9, n_pts)], -1)


def refine_scene(bundle, B, H, W, device, seed=SEED):
    """A port Reconstruction of the bundle on `device`: every image
    registered at the bundle's pose, keypoint k of every image observing
    point k (at the bundle's noisy xyz), the camera's integration grid
    H×W; and ImagePriors (the main path's conf) on B images spread over
    the bundle, activated. Image b's depth prior is the plane fitted (in
    inverse depth) to its true points' depths, times a scale error in
    [0.9, 1.1] and 3% log-normal noise, with a 5% std; its normals are the
    plane's, with a 2° std. Returns (rec, pris, truth): truth[imid] the
    true points' depths in the image (keypoint order)."""
    rng = np.random.default_rng(seed + 5)
    C, P = bundle.quat.shape[0], bundle.xyz.shape[0]
    rec = scene_reconstruction(bundle, range(C), bundle.quat, bundle.t)
    cam = rec.cameras[1]
    cam.int_width, cam.int_height = W, H
    lanes = np.linspace(0, C - 1, B).round().astype(int)
    for k in range(P):
        rec.add_point3D(bundle.xyz[k].astype(np.float64), [(c, k) for c in range(C)])
    pts = bench_points(P, seed)
    pris, truth = [], {}
    for c in lanes:
        truth[int(c)] = rec.images[c].pose.transform(pts)[:, 2]
        pris.append(lane_prior(rec, int(c), truth[int(c)], H, W, rng, device))
    return rec, pris, truth


def lane_prior(rec, c, z, H, W, rng, device):
    """ImagePriors (the main path's conf) of image c, activated, on the
    camera's H×W integration grid: the plane fitted (in inverse depth) to
    its keypoints' true depths z, times a scale error in [0.9, 1.1] and 3%
    log-normal noise, with a 5% std; the plane's normals with a 2° std."""
    from mpsfm_tpu_torch.scene.image_priors import ImagePriors

    cam = rec.cameras[1]
    fx, fy, cx, cy = FOCAL * cam.sx, FOCAL * cam.sy, IMG_W / 2 * cam.sx, IMG_H / 2 * cam.sy
    xs, ys = np.meshgrid((np.arange(W) + 0.5 - cx) / fx, (np.arange(H) + 0.5 - cy) / fy)
    uv = (rec.images[c].keypoints - [IMG_W / 2, IMG_H / 2]) / FOCAL
    abc = np.linalg.lstsq(np.c_[uv, np.ones(len(uv))], 1.0 / z, rcond=None)[0]  # 1/z = a·x + b·y + c
    plane = 1.0 / np.clip(abc[0] * xs + abc[1] * ys + abc[2], 1e-3, None)
    prior = plane * rng.uniform(0.9, 1.1) * np.exp(rng.normal(scale=0.03, size=plane.shape))
    n = -abc / np.linalg.norm(abc)
    pri = ImagePriors(
        {}, rec, c,
        depth_dict={"depth": prior, "depth_variance": (0.05 * prior) ** 2},
        normals_dict={"normals": np.broadcast_to(n, (H, W, 3)).copy(),
                      "normals_variance": np.full((H, W), (np.pi / 180 * 2) ** 2)},
        device=device,
    )
    im = rec.images[c]
    im.priors, im.depth, im.normals = pri, pri.depth, pri.normals
    pri.depth.activate()
    return pri


def global_bundle(rec):
    """The mapper's global bundle (mapper/mapper.py:find_global_bundle)."""
    return {"optim_ids": set(rec.reg_image_ids()), "pts3D": set(rec.point_ids().tolist()), "constpoints": set()}


def local_bundle(rec, ref, n=5):
    """The mapper's local bundle of image ref (find_local_bundle)."""
    optim_ids = set(rec.find_local_bundle_ids(ref, n)) | {ref}
    pts = set()
    for imid in optim_ids:
        ids = rec.images[imid].point3D_ids
        pts.update(ids[ids >= 0].tolist())
    ids = rec.images[ref].point3D_ids
    own = set(ids[ids >= 0].tolist())
    return {"ref_id": ref, "optim_ids": optim_ids, "pts3D": own, "constpoints": pts - own}


def run_scene_refinement(rec, pris, device, times=None, opt_conf=None):
    """The refinement steps of the JAX package's Mapper.adjust_bundle with
    int_covs on, through the port's entry points on `device`: point
    covariances; a global step (integrate_bundle_deferred over every
    prior lane; more than 2 lanes, so finalize_integration, then
    int_covs_bundle_batched on the changed lanes; Optimizer.ba_fused with
    update_trunc); a local step of one image (integrate_bundle_deferred,
    int_covs_bundle_deferred, ba_fused with the chained variances); then
    optimize_prior_shiftscale, Depth.rescale and refine_3d_points. `times`
    (a dict) collects each entry point's wall seconds, the host
    build_ba_data passes apart; opt_conf is the Optimizer's conf (the main
    path's by default). Returns what the checks read."""
    import torch

    from mpsfm_tpu_torch.mapper.optimizer import Optimizer
    from mpsfm_tpu_torch.scene import image_priors as ip
    from mpsfm_tpu_torch.utils.profiling import TIMERS

    times = {} if times is None else times
    dev = torch.device(device)
    opt = Optimizer(opt_conf or {}, rec, device=dev)
    TIMERS.reset()

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times[name] = time.perf_counter() - t0
        return r

    out = {"unc0": {p.imid: np.array(p.depth.uncertainty_update) for p in pris}}
    bundle = global_bundle(rec)
    timed("calculate_point_covs", opt.calculate_point_covs, bundle)
    out["cov"] = rec.point_covs.device_view()[0]
    out["slots"] = rec.point_covs.slots_for(rec.point_ids())
    handles, pending = timed("integrate_bundle_deferred", ip.integrate_bundle_deferred, pris)
    changed = timed("finalize_integration", ip.finalize_integration, pending)
    out["changed"] = changed
    out["z"] = {p.imid: handles[p.imid][0][handles[p.imid][1]] for p in pris}
    need = [p for p in pris if changed[p.imid]]
    timed("int_covs_bundle_batched", ip.int_covs_bundle_batched, need)
    out["unc1"] = {p.imid: np.array(p.depth.uncertainty_update) for p in pris}

    def z_getter(h):
        return lambda imid: (h[imid][0][h[imid][1]], 0.0) if imid in h else rec.images[imid].priors._z0_shift_dev()

    out["ba_global"] = timed("ba_fused_global", opt.ba_fused, bundle, "global", z_getter(handles),
                             allow_scale_filter=True, update_trunc=True)
    out["device_resident"] = {p.imid: p.depth._data is None and p.depth._data_dev is not None for p in need}
    out["trunc"] = opt.truncation_multiplier

    ref = pris[len(pris) // 2]
    lb = local_bundle(rec, ref.imid)
    handles, pending = timed("integrate_bundle_deferred_local", ip.integrate_bundle_deferred, [ref])
    info_map = {p.imid: (info, k) for g, _z, info in pending for k, p in enumerate(g)}
    unc_over, pending_covs = timed("int_covs_bundle_deferred", ip.int_covs_bundle_deferred, [ref], handles,
                                   info_map)
    out["ba_local"] = timed("ba_fused_local", opt.ba_fused, lb, "local", z_getter(handles), pending=pending,
                            allow_scale_filter=True, unc_overrides=unc_over, pending_covs=pending_covs)

    shift_scale, ok = timed("optimize_prior_shiftscale", opt.optimize_prior_shiftscale, bundle)
    t0 = time.perf_counter()
    for imid, (shift, scale) in shift_scale.items():
        rec.images[imid].depth.rescale(shift, scale)
    times["rescale"] = time.perf_counter() - t0
    out["shift_scale"] = shift_scale
    out["refine"] = timed("refine_3d_points", opt.refine_3d_points, bundle)
    times["build_ba_data (ba_fused, refine_3d_points)"] = TIMERS.totals["ba.build_data"]
    times["build_ba_data (calculate_point_covs)"] = TIMERS.totals["point_covs.build"]
    if "ba.block_schur_tables" in TIMERS.totals:  # a bundle above the dense layout
        times["make_block_schur_tables (in build_ba_data)"] = TIMERS.totals["ba.block_schur_tables"]
    out["quat"] = np.stack([rec.images[i].pose.q for i in sorted(rec.images)])
    out["t"] = np.stack([rec.images[i].pose.t for i in sorted(rec.images)])
    out["xyz"] = rec.xyz[rec.point_ids()].copy()
    out["unc"] = {p.imid: np.array(p.depth.uncertainty_update) for p in pris}
    return out


def check_scene_refinement(out, rec, pris, truth, bundle):
    """The scene refinement phase's checks; raises on the first that
    fails. Returns numbers to print."""
    cov = out["cov"].double().cpu().numpy()
    asym = np.abs(cov - cov.transpose(0, 2, 1)).max() / np.abs(cov).max()
    if not (np.isfinite(cov).all() and asym < 1e-5 and (np.einsum("pii->pi", cov) > 0).all()):
        raise AssertionError(f"scene covariances not finite, symmetric ({asym}) or with a positive diagonal")
    if not (out["slots"] >= 0).all():  # else the anchors take the default covariance (slot -1) silently
        raise AssertionError(f"{int((out['slots'] < 0).sum())} points have no slot in the parked covariances")
    for k in ("ba_global", "ba_local", "refine"):
        info, ok = out[k]
        if not (ok and info["cost"] < info["cost0"] and info["accepted"] >= 1):
            raise AssertionError(f"{k}: {info}, success {ok}")
    C = bundle.quat.shape[0]
    moved_q = np.abs(out["quat"] - bundle.quat.astype(np.float64)).max(1)
    moved_x = np.abs(out["xyz"] - bundle.xyz.astype(np.float64)).max()
    if not (moved_q[0] <= 1e-6 and (moved_q[1:] > 1e-6).all() and moved_x > 1e-6 and np.isfinite(out["xyz"]).all()):
        raise AssertionError(f"poses or points not written back: quat moved {moved_q}, xyz moved {moved_x}")
    changed = [p for p in pris if out["changed"][p.imid]]
    if not changed or not all(out["device_resident"].values()):
        raise AssertionError(f"changed lanes {out['changed']}, device-resident after the BA {out['device_resident']}")
    gaps = {}
    for p in changed:
        kps = rec.images[p.imid].keypoints
        inside = (kps[:, 0] >= 0) & (kps[:, 0] < IMG_W) & (kps[:, 1] >= 0) & (kps[:, 1] < IMG_H)
        t = truth[p.imid][inside]
        refined = np.abs(np.log(p.depth.data_at_kps(kps[inside]) / t)).mean()
        prior = np.abs(np.log(out["prior_kps"][p.imid][inside] / t)).mean()
        gaps[p.imid] = (float(refined), float(prior))
    if not all(r < q for r, q in gaps.values()):
        raise AssertionError(f"refined maps not closer to the points' true depths than their priors: {gaps}")
    moved = {}
    for p in changed:
        u0, u1 = out["unc0"][p.imid], out["unc1"][p.imid]
        moved[p.imid] = float((u1 != u0).mean())
        if not (np.isfinite(u1).all() and (u1 > 0).all() and moved[p.imid] > 0.9):
            raise AssertionError(f"uncertainty_update of image {p.imid}: finite {np.isfinite(u1).all()}, "
                                 f"positive {(u1 > 0).all()}, moved at {moved[p.imid]:.3f} of the keypoints")
    if not np.isfinite(out["trunc"]):
        raise AssertionError(f"truncation multiplier {out['trunc']}")
    return dict(gaps=gaps, moved=moved, cams=C)


def scene_k3_args(rec, pris, dev):
    """K3's inputs as int_covs_bundle_batched gives them for the lanes
    `pris`: the downscaled problems with their anchors priced by the
    parked covariances, the operator at the working z, the deflation
    set-up, every keypoint's query and the iteration count."""
    from mpsfm_tpu_torch.integration import bini, bini_diag, bini_fused
    from mpsfm_tpu_torch.scene import image_priors as ip

    with rec.tri_angle_cache():
        entries = [(p, p._int_cov_query()) for p in pris]
    params = entries[0][1][6]
    anch = ip._group_anchors(entries, tuple(entries[0][1][0][4][1].shape[-2:]), dev)
    inp = bini._unpack(bini._assemble_batch_anchors(anch, ip._cov_dev_or_dummy(rec, dev), [q[0][4] for _, q in entries]))
    st, _, dg = bini._operator(inp, params, *bini_fused.weights(inp.z0, params.k))
    rowcol = ip._query_rows(entries, dev)
    return st, bini_diag.deflation(st, dg), rowcol[:, 0], rowcol[:, 1], params.cg_max_iter


def scene_refinement_phase(dev, bundle, counted, size=FULL):
    """The refinement steps driven from the scene (slices 5b and the front
    of 6a) at `size`: a Reconstruction of the bundle with ImagePriors on
    size["B"] images at size["H"]×size["W"], run once to warm up, then
    once on a fresh scene with the launch counts set to 0 just before;
    checks, one line per entry point's wall time, the launches, and K3
    held to its plain version (k3_check) and timed at
    int_covs_bundle_batched's shapes. Returns (times, launches)."""
    import torch

    dev = torch.device(dev)
    t = time.perf_counter()
    rec, pris, truth = refine_scene(bundle, size["B"], size["H"], size["W"], dev)
    build_s = time.perf_counter() - t
    run_scene_refinement(rec, pris, dev)  # warm-up
    rec, pris, truth = refine_scene(bundle, size["B"], size["H"], size["W"], dev)
    prior_kps = {p.imid: p.depth.data_prior_at_kps(rec.images[p.imid].keypoints) for p in pris}
    for k in counted.values():
        k.launches = 0
    times = {}
    t = time.perf_counter()
    out = run_scene_refinement(rec, pris, dev, times)
    wall = time.perf_counter() - t
    launches = {name: k.launches for name, k in counted.items()}
    out["prior_kps"] = prior_kps
    q = check_scene_refinement(out, rec, pris, truth, bundle)
    C, P = bundle.quat.shape[0], bundle.xyz.shape[0]
    print(f"scene refinement: {C} images x {P} points, ImagePriors on {len(pris)} images at {size['H']}x{size['W']} "
          f"(scene and priors built in {build_s:.3f} s); {wall:.3f} s wall")
    for k in ("ba_global", "ba_local", "refine"):
        info = out[k][0]
        print(f"scene refinement {k}: cost {info['cost0']:.6g} -> {info['cost']:.6g}, {info['accepted']} accepted")
    print(f"scene refinement: changed lanes {sorted(i for i, c in out['changed'].items() if c)}, device-resident "
          f"until read; mean |log(d / z_true)| at the keypoints, refined vs prior "
          f"{ {i: (round(a, 5), round(b, 5)) for i, (a, b) in q['gaps'].items()} }; uncertainty_update moved at "
          f"{ {i: round(v, 4) for i, v in q['moved'].items()} } of the keypoints; truncation multiplier "
          f"{out['trunc']:.6g}; shift/scale {len(out['shift_scale'])} images")
    for name, sec in times.items():
        print(f"scene refinement {name}: {sec:.4f} s wall")
    if dev.type == "cuda":
        from mpsfm_tpu_torch.integration import bini_diag

        args = scene_k3_args(rec, pris, dev)
        k3_check("scene refinement", args)
        n_rhs = args[2].numel()
        print(f"scene refinement K3 at int_covs_bundle_batched's shapes ({args[2].shape[0]} lanes x {args[2].shape[1]} "
              f"keypoints of {'x'.join(map(str, args[1].minv.shape[1:]))}, {n_rhs} right-hand sides, {args[4]} "
              f"iterations): {cuda_ms(lambda: bini_diag.deflated_pcg(*args), 2):.3f} ms")
    if unlaunched(launches):
        raise AssertionError(f"kernels {unlaunched(launches)} were not launched in the scene refinement phase")
    return times, launches


def scene_refinement_card_vs_cpu(dev, size=SMALL):
    """The scene refinement phase at a small size on the card and on the
    CPU from the same seed, twice. With the main path's 20 LM iterations:
    the same changed maps, and z of the global step, covariances,
    uncertainty_update and each BA's cost within the small chain's
    tolerances; the accepted counts are printed, not held, since the LM's
    rel_tol latch fires at an iteration that float32 order decides
    (ROADMAP queue 3; tests/test_torch_dense_ba.py). With LATCH_FREE_ITERS
    iterations, before any latch: the same accepted counts, and poses,
    points, costs and the truncation multiplier within the tolerances.
    Returns the gaps."""
    b = synthetic_bundle(size["n_cams"], size["n_pts"])
    gaps = {}
    tol = dict(z_max=1e-3, z_mean=1e-4, cov_rel=COV_REL, unc_rel=VAR_REL, cost_rel=1e-3, quat=1e-4, t=1e-4,
               xyz=1e-3, trunc_rel=1e-4)
    bas = ("ba_global", "ba_local", "refine")
    for iters in (LM_ITERS, LATCH_FREE_ITERS):
        runs = []
        for d in (dev, "cpu"):
            rec, pris, _ = refine_scene(b, size["B"], size["H"], size["W"], d)
            runs.append(run_scene_refinement(rec, pris, d, opt_conf={"max_iters": iters}))
        g, c = runs
        accepted = {k: (g[k][0]["accepted"], c[k][0]["accepted"]) for k in bas}
        gap = dict(cost_rel=max(abs(g[k][0]["cost"] - c[k][0]["cost"]) / c[k][0]["cost"] for k in bas))
        if iters == LM_ITERS:
            dz = np.concatenate([(g["z"][i].cpu() - c["z"][i]).abs().numpy().ravel() for i in c["z"]])
            gap.update(
                z_max=float(dz.max()), z_mean=float(dz.mean()),
                cov_rel=float((g["cov"].cpu() - c["cov"]).abs().max() / c["cov"].abs().max()),
                unc_rel=max(float((np.abs(g["unc"][i] - c["unc"][i]) / c["unc"][i]).max()) for i in c["unc"]),
            )
        else:
            gap.update(
                quat=float(np.abs(g["quat"] - c["quat"]).max()), t=float(np.abs(g["t"] - c["t"]).max()),
                xyz=float(np.abs(g["xyz"] - c["xyz"]).max()), trunc_rel=abs(g["trunc"] - c["trunc"]) / abs(c["trunc"]),
            )
        line = (f"scene refinement, small ({size['n_cams']} x {size['n_pts']}, {size['B']} priors at "
                f"{size['H']}x{size['W']}), {iters} LM iterations, card vs CPU: changed maps "
                f"{'equal' if g['changed'] == c['changed'] else 'DIFFER'}; {gap} (tolerances "
                f"{ {k: tol[k] for k in gap} }); accepted steps card, CPU {accepted}")
        print(line)
        bad = [k for k in gap if not gap[k] <= tol[k]]
        if g["changed"] != c["changed"] or bad or (iters == LATCH_FREE_ITERS and any(a != b for a, b in accepted.values())):
            raise AssertionError(line)
        gaps.update(gap)
    return gaps


def small_reference(dev):
    """The chain at a small size on the card (kernels) and on the CPU
    (plain versions): the same inputs must give the same result, with the
    depth std floored at INT_COV_FLOOR and unfloored (0, where K3's
    variances reach the depth rows; sigma² must then differ from the
    floored run's). Also the covariances' scatter path (no per-(point,
    camera) tables), card vs CPU."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.ba.covariance import point_covariances

    inputs = make_inputs(**SMALL)
    tol = dict(z=1e-3, quat=1e-4, t=1e-4, xyz=1e-3, cost_rel=1e-3, cov_rel=COV_REL, varlog_rel=VAR_REL,
               sigma2_rel=VAR_REL)
    sigma2 = {}
    for floor in (INT_COV_FLOOR, 0.0):
        gpu = run_slice(inputs, dev, floor=floor)
        cpu = run_slice(inputs, "cpu", floor=floor)
        gaps = {k: float((gpu[k].cpu() - cpu[k]).abs().max()) for k in ("z", "quat", "t", "xyz")}
        gaps["cost_rel"] = abs(gpu["cost"] - cpu["cost"]) / cpu["cost"]
        gaps["cov_rel"] = float((gpu["cov"].cpu() - cpu["cov"]).abs().max() / cpu["cov"].abs().max())
        for k in ("varlog", "sigma2"):
            gaps[f"{k}_rel"] = float(((gpu[k].cpu() - cpu[k]).abs() / cpu[k].abs()).max())
        print(f"small chain (depth std floor {floor}), card vs CPU: {gaps} (tolerances {tol})")
        bad = [k for k in tol if not gaps[k] <= tol[k]]
        if bad:
            raise AssertionError(f"card and CPU disagree on {bad} at floor {floor}: {gaps}")
        sigma2[floor] = gpu["sigma2"][:, :inputs.priors.Sd].cpu()[torch.as_tensor(inputs.priors.ptidx < inputs.P)]
    if bool((sigma2[0.0] == sigma2[INT_COV_FLOOR]).any()):
        raise AssertionError("an unfloored keypoint variance equals the floored one: K3's value does not reach sigma²")
    print(f"small chain: unfloored sigma² / floored, median {float((sigma2[0.0] / sigma2[INT_COV_FLOOR]).median()):.4g}")
    arrays = {**inputs.ba, "pc_r_slot": None, "pc_r_mask": None, "pc_d_slot": None, "pc_d_mask": None}
    gpu = point_covariances(convert.ba_data(arrays, device=dev))
    cpu = point_covariances(convert.ba_data(arrays, device="cpu"))
    rel = float((gpu.cpu() - cpu).abs().max() / cpu.abs().max())
    print(f"covariances by the scatter path (index_put_ accumulate), card vs CPU: max|Δcov| / max|cov| = {rel:.3e} "
          f"(tolerance {COV_REL})")
    if not rel <= COV_REL:
        raise AssertionError(f"scatter-path covariances disagree card vs CPU: {rel}")


# ---- the mapping phase (slice 6b) ----

def _rotvec_quat(v):
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.array([1.0, 0, 0, 0])
    ax = v / th
    return np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * ax])


# tests/synthetic.PlaneScene's defaults, the only values the mapping phases use: its plane
# n·p = n_z·d0 and the wedge's second plane (normals before normalisation), keypoint noise (px),
# outlier share of each pair's matches, visibility, depth prior noise (log) and scale error,
# normal prior noise (deg), and the priors' conf
SCENE_PLANES = [((0.25, -0.15, -1.0), 5.0), ((-0.45, 0.1, -1.0), 3.6)]
KP_NOISE, OUTLIER_FRAC, VISIBILITY = 0.4, 0.1, 0.9
DEPTH_NOISE, DEPTH_SCALE_ERR, NORMALS_NOISE_DEG = 0.02, (0.9, 1.1), 3.0
PRIORS_CONF = {"depth": {"prior_uncertainty": False, "depth_uncertainty": 0.03}, "cg_max_iter": 200, "max_iter": 4,
               "downscaled": True, "downscale_factor": 2}


class MappingScene:
    """A numpy copy of tests/synthetic.PlaneScene at its default noise
    model (geometry and draws in the same order) that builds the port's
    Reconstruction and ImagePriors: a tilted plane seen by cameras moving
    along x, with wedge=True a second plane forming a corner (depth = the
    nearer plane along each ray). Points on the surface in camera 0's view."""

    def __init__(self, n_images=8, n_points=400, img_wh=(160, 120), focal=200.0, baseline=0.35, wedge=False,
                 rng=None):
        from mpsfm_tpu_torch.scene.reconstruction import Pose

        self.rng = rng or np.random.default_rng(0)
        self.W, self.H = img_wh
        self.focal = focal
        self.wedge = wedge
        self.planes = [(np.array(n) / np.linalg.norm(n), d0) for n, d0 in SCENE_PLANES[:1 + wedge]]
        self.poses = [Pose(_rotvec_quat(np.array([0.01, 0.015, 0.005]) * i),
                           np.array([-baseline * i, 0.03 * i, 0.02 * i])) for i in range(n_images)]
        u = self.rng.uniform(-0.55, 0.55, n_points)
        v = self.rng.uniform(-0.45, 0.45, n_points)
        z = self._ray_depth(u, v)
        self.points = np.stack([u * z, v * z, z], -1)

    def _ray_depth(self, u, v, pose=None):
        """Depth along normalized rays (u, v, 1) in camera 0's frame (pose
        None) or pose's: the nearest plane's."""
        r = np.stack([u, v, np.ones_like(u)], -1)
        if pose is None:
            c = np.zeros(3)
        else:
            r = np.einsum("ij,...j->...i", pose.rotation_matrix().T, r)
            c = pose.center()
        best = np.full(u.shape, np.inf)
        for n, d0 in self.planes:
            denom = np.einsum("i,...i->...", n, r)
            s = (n[2] * d0 - n @ c) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            best = np.minimum(best, np.where(s > 0.05, s, np.inf))
        return np.where(np.isfinite(best), best, 0.1)

    def _rays(self):
        xx, yy = np.meshgrid(np.arange(self.W, dtype=np.float64), np.arange(self.H, dtype=np.float64))
        return (xx - self.W / 2) / self.focal, (yy - self.H / 2) / self.focal

    def plane_depth(self, pose):
        return np.clip(self._ray_depth(*self._rays(), pose), 0.1, None)

    def cam_normals(self, pose):
        R = pose.rotation_matrix()
        if not self.wedge:
            return np.broadcast_to(R @ self.planes[0][0], (self.H, self.W, 3)).copy()
        u, v = self._rays()
        r = np.einsum("ij,hwj->hwi", R.T, np.stack([u, v, np.ones_like(u)], -1))
        c = pose.center()
        depths = []
        for n, d0 in self.planes:
            denom = np.einsum("i,hwi->hw", n, r)
            s = (n[2] * d0 - n @ c) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            depths.append(np.where(s > 0.05, s, np.inf))
        n1, n2 = (R @ n for n, _ in self.planes)
        return np.where((depths[1] < depths[0])[..., None], n2[None, None], n1[None, None]).copy()

    def build(self, device, int_wh=None):
        """(rec, keypoints, matches, truth) as PlaneScene.build gives them,
        with ImagePriors on `device`; int_wh is the integration grid (the
        image by default)."""
        from mpsfm_tpu_torch.scene.image_priors import ImagePriors
        from mpsfm_tpu_torch.scene.reconstruction import HostCamera, ImageRecord, Pose, Reconstruction

        rng = self.rng
        rec = Reconstruction()
        cam = HostCamera(1, np.array([self.focal, self.focal, self.W / 2, self.H / 2]), self.W, self.H)
        cam.int_width, cam.int_height = int_wh or (self.W, self.H)
        rec.add_camera(cam)
        keypoints, kp_of_point = {}, {}
        for i, pose in enumerate(self.poses):
            im = ImageRecord(i, f"im{i}.jpg", 1)
            p_cam = pose.transform(self.points)
            z = p_cam[:, 2]
            px = p_cam[:, :2] / z[:, None] * self.focal + np.array([self.W / 2, self.H / 2])
            vis = ((z > 0.1) & (px[:, 0] > 2) & (px[:, 0] < self.W - 2) & (px[:, 1] > 2) & (px[:, 1] < self.H - 2)
                   & (rng.uniform(size=len(z)) < VISIBILITY))
            if self.wedge:  # the point must be the nearest surface
                dmap = self.plane_depth(pose)
                ui = np.clip(px[:, 0].astype(int), 0, self.W - 1)
                vi = np.clip(px[:, 1].astype(int), 0, self.H - 1)
                vis &= z <= dmap[vi, ui] * 1.02 + 0.02
            idxs = np.where(vis)[0]
            kps = px[idxs] + rng.normal(scale=KP_NOISE, size=(len(idxs), 2))
            keypoints[im.name] = kps
            kp_of_point.update({(i, int(g)): k for k, g in enumerate(idxs)})
            im.keypoints = kps
            im.point3D_ids = np.full(len(kps), -1, np.int64)
            rec.add_image(im)
        matches = {}
        for i in range(len(self.poses)):
            for j in range(i + 1, len(self.poses)):
                shared = [p for p in range(len(self.points)) if (i, p) in kp_of_point and (j, p) in kp_of_point]
                if len(shared) < 16:
                    continue
                m = np.array([[kp_of_point[(i, p)], kp_of_point[(j, p)]] for p in shared], np.int64)
                n_out = int(OUTLIER_FRAC * len(m))  # 1 at least, of 16 matches or more
                rows = rng.choice(len(m), n_out, replace=False)
                m[rows, 1] = rng.integers(0, len(keypoints[f"im{j}.jpg"]), n_out)
                matches[(f"im{i}.jpg", f"im{j}.jpg")] = np.unique(m, axis=0)
        rad = np.deg2rad(NORMALS_NOISE_DEG)
        for i, pose in enumerate(self.poses):
            depth = self.plane_depth(pose) * rng.uniform(*DEPTH_SCALE_ERR)
            depth = depth * np.exp(rng.normal(scale=DEPTH_NOISE, size=depth.shape))
            normals = self.cam_normals(pose)
            v = rng.normal(scale=rad, size=normals.shape)
            v -= (v * normals).sum(-1, keepdims=True) * normals
            n = normals + v
            normals_dict = {"normals": n / np.clip(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12, None),
                            "normals_variance": np.full(normals.shape[:2], rad**2)}
            pri = ImagePriors(PRIORS_CONF, rec, i, depth_dict={"depth": depth}, normals_dict=normals_dict,
                              device=device)
            rec.images[i].priors, rec.images[i].depth, rec.images[i].normals = pri, pri.depth, pri.normals
        truth = {"poses": [Pose(p.q.copy(), p.t.copy()) for p in self.poses], "points": self.points}
        return rec, keypoints, matches, truth


def ate_rmse(rec, gt_poses):
    """ATE RMSE of the registered camera centres after a similarity
    alignment (Umeyama), as tests/synthetic.ate_rmse computes it."""
    est = np.stack([rec.images[i].pose.center() for i in rec.reg_image_ids()])
    gt = np.stack([gt_poses[i].center() for i in rec.reg_image_ids()])
    mu_s, mu_d = est.mean(0), gt.mean(0)
    sc, dc = est - mu_s, gt - mu_d
    U, D, Vt = np.linalg.svd(dc.T @ sc / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / ((sc ** 2).sum() / len(est))
    aligned = (s * (R @ est.T)).T + (mu_d - s * R @ mu_s)
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))


# the mapping scene: 12 images (scripts/bench_mapping.py), a 640×480 camera at focal 520 with the
# integration grid of the main path (387×290), 4096 points on the corner of two planes, the camera
# moving 0.18 a frame (bench_mapping's baseline); the small scene is __graft_entry__.dryrun_pipeline's
MAPPING = dict(seed=SEED + 7, n_images=12, n_points=4096, img_wh=(640, 480), focal=520.0, baseline=0.18, wedge=True,
               int_wh=(387, 290), num_hyp=512)
MAPPING_SMALL = dict(seed=3, n_images=5, n_points=200, num_hyp=128)
# the main path's mapper conf (configs/classical-nn_measured.yaml's mapper section over the defaults),
# with the uncertainty chain and the depth-consistency check on, on one card
MAPPER_CONF = {"int_covs": True, "depth_consistency": True, "ba": {"max_iters": 20, "dist_ba": "off"}}
# the bounds: ATE of tests/test_mapper_e2e.py:40 on a scene of the same extent; the share of the
# scene's points in the map; the point counts card vs CPU
MAPPING_ATE, MAPPING_POINT_SHARE, MAPPING_POINTS_REL = 0.05, 0.4, 0.05
# the full scene's bounds, set from its sound runs on the card (ATE 0.00071, 99.8% of the points
# mapped): a map several times worse than those fails
MAPPING_FULL_BOUNDS = (0.005, 0.95)


def mapping_state(dev, seed, n_images, n_points, num_hyp, img_wh=(160, 120), focal=200.0, baseline=0.35,
                  wedge=False, int_wh=None, corr=None):
    """A MappingScene on `dev`, its matches verified by
    Correspondences.populate there (corr: a populated Correspondences
    whose verification is taken instead, as convert.correspondences copies
    it). Returns (rec, corr, truth, seconds of the build, of populate)."""
    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.scene.correspondences import Correspondences

    t = time.perf_counter()
    scene = MappingScene(rng=np.random.default_rng(seed), n_images=n_images, n_points=n_points, img_wh=img_wh,
                         focal=focal, baseline=baseline, wedge=wedge)
    rec, keypoints, matches, truth = scene.build(dev, int_wh=int_wh)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    if corr is None:
        corr = Correspondences({"num_hyp": num_hyp}, rec, device=dev)
        corr.populate(keypoints, matches)
    else:
        corr = convert.correspondences(corr, rec, device=dev)
    return rec, corr, truth, build_s, time.perf_counter() - t


def run_mapping(rec, corr, dev, num_hyp, conf=None):
    """MpsfmMapper on `dev` over (rec, corr) with the main path's conf and
    `num_hyp` hypotheses a registration. Returns (rec, ok, mapper, wall
    seconds, [(imid, seconds, ok) of each next-image registration])."""
    import torch

    from mpsfm_tpu_torch.mapper import MpsfmMapper

    dev = torch.device(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    mapper = MpsfmMapper({**MAPPER_CONF, "registration": {"num_hyp": num_hyp}, **(conf or {})}, rec, corr, device=dev)
    reg = mapper.registration
    register = reg.register_and_triangulate_next_image
    walls = []

    def timed(imid, ref_imids=None):
        t = time.perf_counter()
        ok = register(imid, ref_imids=ref_imids)
        sync()
        walls.append((imid, time.perf_counter() - t, ok))
        return ok

    reg.register_and_triangulate_next_image = timed
    t = time.perf_counter()
    rec, ok = mapper()
    sync()
    return rec, ok, mapper, time.perf_counter() - t, walls


def mapping_summary(rec, ok, mapper, truth, n_points, bounds=(MAPPING_ATE, MAPPING_POINT_SHARE)):
    """The mapped scene's numbers; raises unless it registered every image
    with an ATE below bounds[0] and bounds[1] of the n_points in the map,
    and the uncertainty chain ran."""
    ate_bound, share = bounds
    ate = ate_rmse(rec, truth["poses"]) if rec.num_reg_images() >= 3 else float("inf")
    int_covs = [i for i, im in rec.images.items() if getattr(getattr(im, "priors", None), "int_covs_applied", False)]
    out = dict(ok=bool(ok), registered=rec.num_reg_images(), images=rec.num_images(), points=rec.num_points3D(),
               ate=ate, order=[i for i in mapper.nextview.registration_order if i is not None], int_covs=int_covs,
               point_covs=len(rec.point_covs))
    if not (ok and out["registered"] == out["images"] and ate < ate_bound and out["points"] >= share * n_points
            and int_covs and out["point_covs"] > 0):
        raise AssertionError(f"mapping: {out} (bounds: every image registered, ATE < {ate_bound}, >= {share} of "
                             f"{n_points} points, int_covs applied, point covariances)")
    return out


@contextlib.contextmanager
def last_call(module, name, size):
    """Swap module.name for a wrapper that keeps the arguments of its last
    call among those of the largest size(args, result) (a dict: "args",
    "kw"); the wrapped function runs as before, launches included."""
    fn = getattr(module, name)
    kept = {"size": None, "args": None, "kw": None}

    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        n = size(args, out)
        if kept["size"] is None or n >= kept["size"]:
            kept["size"], kept["args"], kept["kw"] = n, args, kw
        return out

    setattr(module, name, wrapper)
    try:
        yield kept
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def path_kernel_args():
    """Keep, while a phase runs its path, the arguments at which it is then
    held to each kernel's plain version: K1's at the last of its largest
    reduced systems (the last global BA), K1 many's at the largest
    point-covariance solve, K2's at the PCG with the most lanes (then CG
    iterations; the global integrations' shape) and at the PCG with the
    most CG iterations of all lanes together (a newly registered image's).
    Reading the iteration counts adds a read to each PCG. Yields a dict of
    last_call's dicts."""
    from mpsfm_tpu_torch.ba import covariance, dense
    from mpsfm_tpu_torch.integration import bini

    def cg_iterations(a, out):
        return int(out[1].sum())

    with last_call(dense, "cholesky_solve", lambda a, out: a[0].shape[0]) as k1, \
            last_call(covariance, "cholesky_solve", lambda a, out: a[1].numel()) as k1_many, \
            last_call(bini, "_pcg", lambda a, out: (a[3].shape[0], cg_iterations(a, out))) as k2_wide, \
            last_call(bini, "_pcg", cg_iterations) as k2_busy:
        yield {"K1": k1, "K1 many": k1_many, "K2 widest": k2_wide, "K2 busiest": k2_busy}


def check_path_kernels(phase, kept, rec, dev, pris=None, many_cols=None, k2_budget=False):
    """Each kernel held to its plain version at a phase's own shapes (kept
    by path_kernel_args; K3 at int_covs_bundle_batched's shapes of the final
    map rec, over the priors `pris`, by default every registered image's)
    and timed beside it. K1 takes K1_REL's less dominant class (the last
    global BA's reduced system is as ill-conditioned; its condition number
    printed) or, where the plain version itself is outside it, the float64
    rule (k1_check_in_situ: the prior nets phase's 3-camera system, κ 1.6e7,
    left the kernel 6.2e-6 from the plain version and both at a residual of
    3.1e-3), K1 many K1_ILL_REL and the float64 solve, on the first
    many_cols right-hand sides when given (the kernel still timed on all).
    With k2_budget (the ill-conditioned integrations of K2_SHORT's note),
    K2 runs for the iterations its tolerance took at most, on every lane,
    and is held by k2_f64_check. The plain versions are timed without a
    warm call where their check has just run them on the same inputs
    (all but K1 many on its first many_cols columns). Returns
    {kernel: (ms, plain ms)}."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky
    from mpsfm_tpu_torch.integration import bini_diag, bini_fused

    S, b = kept["K1"]["args"]
    _, line = k1_check_in_situ(S, b, f"K1 at the {phase}'s largest dense BA, the last of them (K={S.shape[0]})")
    times = {"K1": (cuda_ms(lambda: cholesky.cholesky_solve(S, b), 20),
                    cuda_ms(lambda: cholesky.cholesky_solve_plain(S, b), 2, warm=False))}
    print(line)
    S, Bm = kept["K1 many"]["args"]
    kappa = float(torch.linalg.cond(S.double()))
    cols = "" if many_cols is None else f", held on its first {many_cols} columns"
    _, line = k1_many_check(S, Bm if many_cols is None else Bm[:, :many_cols].contiguous(), K1_ILL_REL,
                            f"K1 many at the {phase}'s largest point-covariance solve (K={S.shape[0]}, "
                            f"N={Bm.shape[1]}{cols}, condition number {kappa:.3g})", f64=True)
    times["K1 many"] = (cuda_ms(lambda: cholesky.cholesky_solve(S, Bm), 10),
                        cuda_ms(lambda: cholesky.cholesky_solve_plain(S, Bm), 2, warm=many_cols is not None))
    print(line)
    for name in ("K2 widest", "K2 busiest"):
        st, b2, dg, z, iters, tol, active = kept[name]["args"]
        B, H, W = z.shape
        what = f"{phase}, its {name[3:]} PCG: B={B} {H}x{W}"
        if k2_budget:
            iters, tol = int(bini_fused.pcg(st, b2, dg, z, iters, tol, active)[1].max()), -1.0
            k2 = (st, b2, dg, z, iters, tol)
            k2_f64_check(f"{what}, its tolerance's largest iteration count as a fixed budget", k2, active)
        else:
            k2 = (st, b2, dg, z, iters, tol)
            k2_pcg_check(what, k2, active)
        times[name] = (cuda_ms(lambda: bini_fused.pcg(*k2, active), 5),
                       cuda_ms(lambda: bini_fused.pcg_plain(*k2, active), 1, warm=False))
    pris = [rec.images[i].priors for i in rec.reg_image_ids()] if pris is None else pris
    k3 = scene_k3_args(rec, pris, dev)
    k3_check(f"{phase}, int_covs of the final map", k3)
    times["K3"] = (cuda_ms(lambda: bini_diag.deflated_pcg(*k3), 2),
                   cuda_ms(lambda: bini_diag.deflated_pcg_plain(*k3), 1, warm=False))
    print(f"{phase} kernels at the phase's shapes, kernel / plain version (ms): "
          + ", ".join(f"{k} {a:.4f} / {p:.3f}" for k, (a, p) in times.items()))
    return times


def mapping_phase(dev, counted):
    """MpsfmMapper on the card over the full mapping scene (MAPPING), with
    the launch counts set to 0 just before: every image registered, ATE,
    points, the uncertainty chain and each kernel launched; wall, launches,
    each registration's wall and the phase timers printed. Then each kernel
    held to its plain version at the phase's shapes and timed
    (check_path_kernels). Returns (summary, launches)."""
    import torch

    from mpsfm_tpu_torch.utils.profiling import TIMERS

    dev = torch.device(dev)
    cfg = dict(MAPPING)
    num_hyp = cfg.pop("num_hyp")
    rec, corr, truth, build_s, populate_s = mapping_state(dev, num_hyp=num_hyp, **cfg)
    kps = [len(im.keypoints) for im in rec.images.values()]
    print(f"mapping scene: {cfg['n_images']} images {cfg['img_wh'][0]}x{cfg['img_wh'][1]} (focal {cfg['focal']}, "
          f"integration grid {cfg['int_wh'][0]}x{cfg['int_wh'][1]}), {cfg['n_points']} points, keypoints an image "
          f"{min(kps)} .. {max(kps)}, {len(corr.image_pairs())} verified pairs; built in {build_s:.3f} s, "
          f"Correspondences.populate ({num_hyp} hypotheses) {populate_s:.3f} s wall")
    TIMERS.reset()
    for k in counted.values():
        k.launches = 0
    with path_kernel_args() as kept:
        rec, ok, mapper, wall, walls = run_mapping(rec, corr, dev, num_hyp)
    launches = {name: k.launches for name, k in counted.items()}
    out = mapping_summary(rec, ok, mapper, truth, cfg["n_points"], MAPPING_FULL_BOUNDS)
    print(f"mapping: {wall:.3f} s wall; registered {out['registered']}/{out['images']} in the order "
          f"{out['order']}; {out['points']} points ({out['points'] / cfg['n_points']:.4f} of the scene's, bound "
          f"{MAPPING_FULL_BOUNDS[1]}); ATE {out['ate']:.6f} (bound {MAPPING_FULL_BOUNDS[0]}); int_covs on images {out['int_covs']}, {out['point_covs']} point "
          f"covariances; launches {json.dumps(launches)}")
    print("mapping registrations (image, s wall, ok): "
          + ", ".join(f"({i}, {s:.3f}, {'ok' if g else 'failed'})" for i, s, g in walls))
    print("mapping phase timers (s wall x calls):\n" + TIMERS.summary())
    if unlaunched(launches):
        raise AssertionError(f"kernels {unlaunched(launches)} were not launched in the mapping phase")
    check_path_kernels("mapping phase", kept, rec, dev)
    return out, launches


def mapping_card_vs_cpu(dev):
    """MpsfmMapper on the small scene (MAPPING_SMALL: 5 images × 200
    points, seed 3, dryrun_pipeline's) on the card and on the CPU, from one
    verification (populate on the card, copied to the CPU) and the same
    registration samples: the same registered images in the same order,
    point counts within MAPPING_POINTS_REL, both ATEs below MAPPING_ATE.
    Returns both summaries."""
    import torch

    cfg = dict(MAPPING_SMALL)
    num_hyp = cfg.pop("num_hyp")
    conf = {"ba": {"max_iters": 8, "dist_ba": "off"}}
    runs, corr = {}, None
    for d in (torch.device(dev), torch.device("cpu")):
        rec, corr_d, truth, _, _ = mapping_state(d, num_hyp=num_hyp, corr=corr, **cfg)
        corr = corr or corr_d
        rec, ok, mapper, wall, _ = run_mapping(rec, corr_d, d, num_hyp, conf)
        runs[d.type] = dict(mapping_summary(rec, ok, mapper, truth, 0), wall=wall)
    g, c = runs["cuda"], runs["cpu"]
    gap = abs(g["points"] - c["points"]) / c["points"]
    line = (f"mapping, small scene ({cfg['n_images']} x {cfg['n_points']}, seed {cfg['seed']}), card vs CPU: order "
            f"{g['order']} / {c['order']}, points {g['points']} / {c['points']} (gap {gap:.4f}, bound "
            f"{MAPPING_POINTS_REL}), ATE {g['ate']:.5f} / {c['ate']:.5f}, wall {g['wall']:.3f} / {c['wall']:.3f} s")
    print(line)
    if g["order"] != c["order"] or not gap <= MAPPING_POINTS_REL:
        raise AssertionError(line)
    return runs


# ---- the pipeline phase (slice 7): reconstruct from an RGB-D directory ----

# configs/classical-nn_measured.yaml as a dict (tests/test_torch_pipeline.py holds it equal to the port's
# load_cfg of the file); the phase runs it on one card (dist_ba off) with its stores in the directory
# format, as the card's host has no h5py
MAIN_CONF = {"matches_mode": "sparse+measured",
             "extractors": {"features": "classical", "matcher": "nn", "pairs_type": "exhaustive"},
             "mapper": {"ba": {"max_iters": 20}}}
PIPELINE_CONF = {**MAIN_CONF, "cache_format": "npy", "mapper": {"ba": {"max_iters": 20, "dist_ba": "off"}}}
# the conf of tests/test_pipeline_e2e.py (its _PIPE_CONF), for the small scene
E2E_CONF = {"matches_mode": "sparse+measured", "cache_format": "npy",
            "extractors": {"features": "classical", "matcher": "nn", "pairs_type": "exhaustive",
                           "feature_conf": {"max_keypoints": 1024}, "resize_max": 0},
            "mapper": {"int_covs": False, "ba": {"max_iters": 10, "dist_ba": "off"}, "registration": {"num_hyp": 256}},
            "image_priors": {"cg_max_iter": 150, "max_iter": 3,
                             "depth": {"prior_uncertainty": True, "depth_uncertainty": None,
                                       "prior_std_multiplier": 1.0}}}
# the rendered scenes: the mapping phase's geometry (640×480, focal 520, baseline 0.18, the wedge) cut
# from its 12 images to 8 (with 12 the whole script ran 339 s, past the ~300 s it should stay under),
# and tests/test_pipeline_e2e.py's (5 images of 320×240, focal 260, baseline 0.3, one plane); sensor
# depth with 1% log-normal noise (its depth_noise)
PIPELINE = dict(seed=SEED + 11, n_images=8, img_wh=(640, 480), focal=520.0, baseline=0.18, wedge=True)
PIPELINE_SMALL = dict(seed=SEED + 12, n_images=5, img_wh=(320, 240), focal=260.0, baseline=0.3, wedge=False)
RENDER_DEPTH_NOISE = 0.01
# texture: octave weights of a multi-octave noise (tests/synthetic.render_scene_dir's), its resolution and
# the world span it covers on each plane
TEXTURE_OCTAVES, TEXTURE_RES, PLANE_EXTENT = (1.0, 0.7, 0.5, 0.35, 0.25), 1024, 8.0
# the bounds: ATE of the mapping phase's small scene (for the small scene here); card vs CPU, the share
# of the card's keypoints the CPU finds within KP_MATCH_PX, their descriptors within DESC_TOL (the
# CPU tests' bound against the JAX package), every match equal, the point counts within MAPPING_POINTS_REL
PIPELINE_ATE, KP_MATCH_PX, KP_COMMON, DESC_TOL = MAPPING_ATE, 1e-2, 0.99, 1e-4
# the full scene's bounds (registered images, ATE, points), set from its sound runs on the card (8/8,
# ATE 0.002752, 4682 points; the JAX package on the CPU over the same render: 8/8, 0.005206, 4683): a map
# several times worse fails (the first bounds were >= 11 of 12 images and ATE < 0.05)
PIPELINE_FULL_BOUNDS = (8, 0.02, 4200)
# images of the pipeline phase's warm-up run: an init pair and one registration run every stage on the
# card at the phase's image size (cut from all 8 to keep the script near 400 s with the distributed BA phase)
PIPELINE_WARM_IMAGES = 3


def png_gray(img):
    """PNG bytes of a (H, W) uint8 image: 8-bit grayscale, every row with
    the Paeth filter (the one encoders pick most on smooth images, and the
    dearest to undo), one zlib stream."""
    import struct
    import zlib

    h, w = img.shape
    x = np.pad(img.astype(np.int16), ((1, 0), (1, 0)))
    a, b, c, x = x[1:, :-1], x[:-1, 1:], x[:-1, :-1], x[1:, 1:]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)], 1).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _upsample(layer, n):
    """Bilinear upsampling of a square layer to n×n (corners aligned)."""
    m = layer.shape[0]
    x, grid = np.linspace(0, m - 1, n), np.arange(m)
    rows = np.stack([np.interp(x, grid, r) for r in layer])
    return np.stack([np.interp(x, grid, c) for c in rows.T], 1)


def noise_texture(rng, res=TEXTURE_RES):
    """A multi-octave noise in [0, 1]: uniform layers of 64 .. 1024 texels
    a side, bilinearly upsampled, weighted, summed, then a [1, 2, 1]/4 blur
    a side."""
    tex = np.zeros((res, res))
    for octv, wgt in enumerate(TEXTURE_OCTAVES):
        m = max(8, res >> (len(TEXTURE_OCTAVES) - 1 - octv))
        tex += wgt * _upsample(rng.uniform(-1, 1, (m, m)), res)
    for axis in (0, 1):
        pad = np.pad(tex, [(1, 1) if a == axis else (0, 0) for a in (0, 1)], mode="reflect")
        lo, mid, hi = (np.take(pad, range(k, k + res), axis=axis) for k in range(3))
        tex = 0.25 * lo + 0.5 * mid + 0.25 * hi
    return (tex - tex.min()) / (tex.max() - tex.min())


def _lookup(tex, su, tv):
    """Bilinear lookup of tex at texel coordinates (su along x, tv along y),
    clamped to the texture."""
    n = tex.shape[0]
    su, tv = np.clip(su, 0, n - 1.001), np.clip(tv, 0, n - 1.001)
    x0, y0 = su.astype(np.int64), tv.astype(np.int64)
    fx, fy = su - x0, tv - y0
    return ((tex[y0, x0] * (1 - fx) + tex[y0, x0 + 1] * fx) * (1 - fy)
            + (tex[y0 + 1, x0] * (1 - fx) + tex[y0 + 1, x0 + 1] * fx) * fy)


def render_view(scene, pose, textures):
    """(H, W) gray image in [0, 1] of a MappingScene from `pose`: each pixel
    takes the texture of the nearest plane along its ray, at the world
    point's coordinates in that plane's frame."""
    u, v = scene._rays()
    r = np.einsum("ij,hwj->hwi", pose.rotation_matrix().T, np.stack([u, v, np.ones_like(u)], -1))
    c = pose.center()
    depth = scene.plane_depth(pose)
    img = np.zeros(depth.shape)
    best = np.full(depth.shape, np.inf)
    for (n, d0), tex in zip(scene.planes, textures):
        denom = np.einsum("i,hwi->hw", n, r)
        s = (n[2] * d0 - n @ c) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        s = np.where(s > 0.05, s, np.inf)
        e1 = np.cross(n, [0, 0, 1.0])
        e1 = e1 / np.linalg.norm(e1) if np.linalg.norm(e1) > 1e-6 else np.array([1.0, 0, 0])
        e2 = np.cross(n, e1)
        rel = c + np.where(np.isfinite(s), s, 0)[..., None] * r - np.array([0, 0, d0])
        su = (rel @ e1 / PLANE_EXTENT + 0.5) * (TEXTURE_RES - 1)
        tv = (rel @ e2 / PLANE_EXTENT + 0.5) * (TEXTURE_RES - 1)
        near = s < best
        img = np.where(near, _lookup(tex, su, tv), img)
        best = np.minimum(best, s)
    return img


def render_rgbd_dir(out_dir, seed, n_images, img_wh, focal, baseline, wedge):
    """Render a MappingScene (no points) as an RGB-D directory the pipeline
    reads: images/imNN.png (8-bit gray, png_gray), depth/imNN.npy (the
    surface's depth with RENDER_DEPTH_NOISE log-normal noise) and
    intrinsics.yaml in its JSON form; and the true poses as a COLMAP text
    model in truth/ (for either package's --refrec_dir: python reconstruct.py
    --conf <conf> --data_dir <dir> --refrec_dir <dir>/truth prints the ATE).
    Returns the scene."""
    from pathlib import Path

    from mpsfm_tpu_torch.scene.reconstruction import HostCamera, ImageRecord, Reconstruction
    from mpsfm_tpu_torch.utils.colmap_io import write_text

    rng = np.random.default_rng(seed)
    scene = MappingScene(rng=rng, n_images=n_images, n_points=0, img_wh=img_wh, focal=focal, baseline=baseline,
                         wedge=wedge)
    out = Path(out_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    (out / "depth").mkdir(parents=True, exist_ok=True)
    textures = [noise_texture(rng) for _ in scene.planes]
    for i, pose in enumerate(scene.poses):
        img = render_view(scene, pose, textures)
        (out / "images" / f"im{i:02d}.png").write_bytes(png_gray((img * 255).astype(np.uint8)))
        d = scene.plane_depth(pose)
        np.save(out / "depth" / f"im{i:02d}.npy", d * np.exp(rng.normal(scale=RENDER_DEPTH_NOISE, size=d.shape)))
    params = [focal, focal, img_wh[0] / 2, img_wh[1] / 2]
    (out / "intrinsics.yaml").write_text(json.dumps({"1": {"params": params, "images": "all"}}))
    truth = Reconstruction()
    truth.add_camera(HostCamera(1, np.asarray(params), *img_wh))
    for i, pose in enumerate(scene.poses):  # one keypoint each: COLMAP text readers skip empty lines
        truth.add_image(ImageRecord(i, f"im{i:02d}.png", 1, keypoints=np.array([params[2:]]),
                                    point3D_ids=np.array([-1]), pose=pose.copy(), registered=True))
    write_text(truth, out / "truth")
    return scene


@contextlib.contextmanager
def devices_seen(dense=False):
    """Record the device of each pipeline stage's work as it runs: the
    detector's images, the matcher's descriptors, the verification's device
    and the mapper's; with dense, also the NCC flow's images and the sky
    heuristic's mask. Yields a dict stage -> set of device types."""
    import torch

    from mpsfm_tpu_torch import pipeline
    from mpsfm_tpu_torch.extraction import masks
    from mpsfm_tpu_torch.extraction.features import classical
    from mpsfm_tpu_torch.extraction.matchers import dense_ncc, nn
    from mpsfm_tpu_torch.scene import correspondences

    seen = {k: set() for k in ("features", "matches", "populate", "mapper") + (("dense", "masks") if dense else ())}
    orig = (classical.detect_describe, nn.match, correspondences.estimate_two_view_geometry_batch,
            pipeline.MpsfmMapper, dense_ncc.ncc_flow, masks.sky_mask_heuristic)

    def flow(a, b, *args, **k):
        seen["dense"].add(a.device.type)
        return orig[4](a, b, *args, **k)

    def sky(*args, **k):
        out = orig[5](*args, **k)
        seen["masks"].add(out.device.type)
        return out

    def detect(imgs, *a, **k):
        seen["features"].add(imgs.device.type)
        return orig[0](imgs, *a, **k)

    def match(d0, d1, *a, **k):
        seen["matches"].add(d0.device.type)
        return orig[1](d0, d1, *a, **k)

    def verify(pairs, *a, device, **k):
        seen["populate"].add(torch.device(device).type)
        return orig[2](pairs, *a, device=device, **k)

    def mapper(*a, **k):
        m = orig[3](*a, **k)
        seen["mapper"] |= {m.optimizer.device.type, m.registration.device.type, m.dc.device.type}
        return m

    classical.detect_describe, nn.match, correspondences.estimate_two_view_geometry_batch = detect, match, verify
    pipeline.MpsfmMapper = mapper
    if dense:
        dense_ncc.ncc_flow, masks.sky_mask_heuristic = flow, sky
    try:
        yield seen
    finally:
        (classical.detect_describe, nn.match, correspondences.estimate_two_view_geometry_batch,
         pipeline.MpsfmMapper, dense_ncc.ncc_flow, masks.sky_mask_heuristic) = orig


def run_pipeline(data_dir, conf, dev, cache_dir=None):
    """The port's reconstruct over an RGB-D directory on `dev`, outputs in
    data_dir/sfm_outputs. Returns (rec, ok, wall seconds)."""
    import torch

    from mpsfm_tpu_torch.pipeline import reconstruct

    dev = torch.device(dev)
    t = time.perf_counter()
    rec, ok = reconstruct(data_dir, conf=conf, cache_dir=cache_dir, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return rec, ok, time.perf_counter() - t


def check_written_model(rec, out_dir):
    """The text model in out_dir, read back by the port's read_text, holds
    rec's registered images (names), poses within 1e-6 and point count."""
    from mpsfm_tpu_torch.utils.colmap_io import read_text

    back = read_text(out_dir)
    names = {im.name: im for im in rec.registered_images.values()}
    got = {im.name: im for im in back.registered_images.values()}
    gap = max((max(np.abs(im.pose.q - got[n].pose.q).max(), np.abs(im.pose.t - got[n].pose.t).max())
               for n, im in names.items()), default=0.0) if names.keys() == got.keys() else float("inf")
    if names.keys() != got.keys() or gap > 1e-6 or back.num_points3D() != rec.num_points3D():
        raise AssertionError(f"written model: images {sorted(got)} vs {sorted(names)}, pose gap {gap}, points "
                             f"{back.num_points3D()} vs {rec.num_points3D()}")
    return gap


def pipeline_phase(dev, counted):
    """The port's reconstruct on the card over a rendered RGB-D directory
    (PIPELINE: the mapping phase's geometry, 8 PNG images of 640×480, .npy
    depth, JSON intrinsics) under the main path's conf: a warm-up run on a
    copy of the directory's first PIPELINE_WARM_IMAGES images (every stage,
    at the same image size), then the measured run with the launch counts
    set to 0 just before. Holds: features, matches, populate and the mapper
    on the card, each kernel launched, PIPELINE_FULL_BOUNDS (registered
    images, ATE, points), the written text model equal to the map, and
    each kernel to its plain version at the run's own shapes
    (check_path_kernels). Prints the host's PNG decode time, each pipe.*
    phase's wall, registered images, points, ATE, launches and frames/s.
    Returns (summary, launches)."""
    import shutil
    import tempfile
    from pathlib import Path

    from mpsfm_tpu_torch.utils.io import read_image
    from mpsfm_tpu_torch.utils.profiling import TIMERS

    cfg = dict(PIPELINE)
    min_reg, ate_bound, min_points = PIPELINE_FULL_BOUNDS
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        scene = render_rgbd_dir(Path(tmp) / "scene", **cfg)
        render_s = time.perf_counter() - t
        t = time.perf_counter()  # the host's PNG decode, as _load_gray reads each image once a run
        for path in sorted((Path(tmp) / "scene" / "images").iterdir()):
            read_image(path, grayscale=True)
        decode_s = (time.perf_counter() - t) / cfg["n_images"]
        shutil.copytree(Path(tmp) / "scene", Path(tmp) / "warm")
        for i in range(PIPELINE_WARM_IMAGES, cfg["n_images"]):  # the warm-up maps the first images only
            (Path(tmp) / "warm" / "images" / f"im{i:02d}.png").unlink()
            (Path(tmp) / "warm" / "depth" / f"im{i:02d}.npy").unlink()
        _, _, warm_s = run_pipeline(Path(tmp) / "warm", PIPELINE_CONF, dev)
        TIMERS.reset()
        for k in counted.values():
            k.launches = 0
        with devices_seen() as seen, path_kernel_args() as kept:
            rec, ok, wall = run_pipeline(Path(tmp) / "scene", PIPELINE_CONF, dev)
        launches = {name: k.launches for name, k in counted.items()}
        pipe = {k: round(v, 4) for k, v in TIMERS.totals.items() if k.startswith("pipe.")}
        ate = ate_rmse(rec, scene.poses) if rec.num_reg_images() >= 3 else float("inf")
        gap = check_written_model(rec, Path(tmp) / "scene" / "sfm_outputs")
    out = dict(ok=bool(ok), registered=rec.num_reg_images(), images=rec.num_images(), points=rec.num_points3D(),
               ate=ate, wall=wall, frames_per_s=rec.num_images() / wall, pipe=pipe, devices=seen)
    print(f"pipeline scene: {cfg['n_images']} PNG images {cfg['img_wh'][0]}x{cfg['img_wh'][1]} (focal {cfg['focal']}, "
          f"baseline {cfg['baseline']}, wedge; Paeth-filtered rows), .npy depth, JSON intrinsics; rendered in "
          f"{render_s:.3f} s; PNG decode on the host {decode_s * 1e3:.3f} ms an image; warm-up run ({PIPELINE_WARM_IMAGES} "
          f"images) {warm_s:.3f} s wall")
    print(f"pipeline: {wall:.3f} s wall, {out['frames_per_s']:.4f} frames/s; registered {out['registered']}/"
          f"{out['images']} (bound {min_reg}); {out['points']} points (bound {min_points}); ATE {ate:.6f} (bound "
          f"{ate_bound}); written model read back, pose gap {gap:.2e}; devices {json.dumps({k: sorted(v) for k, v in seen.items()})}; "
          f"launches {json.dumps(launches)}")
    print(f"pipeline pipe.* phases (s wall): {json.dumps(pipe)}")
    print("pipeline phase timers (s wall x calls):\n" + TIMERS.summary())
    if any(v != {"cuda"} for v in seen.values()):
        raise AssertionError(f"pipeline stages off the card: {seen}")
    if unlaunched(launches):
        raise AssertionError(f"kernels {unlaunched(launches)} were not launched in the pipeline phase")
    if not (ok and out["registered"] >= min_reg and ate < ate_bound and out["points"] >= min_points):
        raise AssertionError(f"pipeline: {out} (bounds: >= {min_reg} registered, ATE < {ate_bound}, >= {min_points} "
                             "points)")
    out["kernel_ms"] = check_path_kernels("pipeline phase", kept, rec, dev)
    out["decode_s"] = decode_s
    return out, launches


def nearest_share(ka, kb, tol):
    """Share of ka's keypoints with one of kb's within tol px, and the
    largest such offset."""
    import torch

    d = torch.cdist(torch.as_tensor(ka, dtype=torch.float64), torch.as_tensor(kb, dtype=torch.float64))
    dmin, arg = d.min(1)
    common = dmin <= tol
    return float(common.double().mean()), float(dmin[common].max()) if common.any() else float("inf"), \
        common.numpy(), arg.numpy()


def pipeline_card_vs_cpu(dev):
    """The small scene (PIPELINE_SMALL, E2E_CONF) on the card, then: the
    detector on the card and on the CPU over its images (keypoints as sets:
    the share the CPU finds within KP_MATCH_PX, the largest offset, the
    descriptors of common keypoints within DESC_TOL), the matcher on both
    over the card's descriptors (every match equal), and the mapping on the CPU from the card's
    caches (features, matches, pairs, verification): the same registered
    images and points within MAPPING_POINTS_REL. Returns both summaries."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from mpsfm_tpu_torch.extraction.features.classical import ClassicalFeatures
    from mpsfm_tpu_torch.extraction.matchers.nn import MutualNNMatcher
    from mpsfm_tpu_torch.utils.io import read_image

    cfg = dict(PIPELINE_SMALL)
    with tempfile.TemporaryDirectory() as tmp:
        scene = render_rgbd_dir(Path(tmp) / "scene", **cfg)
        runs = {}
        rec, ok, wall = run_pipeline(Path(tmp) / "scene", E2E_CONF, dev)
        runs["cuda"] = (rec, ok, wall)
        images = [read_image(p, True).astype(np.float32) / 255 for p in sorted((Path(tmp) / "scene/images").iterdir())]
        conf = E2E_CONF["extractors"]["feature_conf"]
        card = ClassicalFeatures(conf, device=dev).batch(images)
        cpu = ClassicalFeatures(conf, device="cpu").batch(images)
        shares, offsets, desc_gap = [], [], 0.0
        for g, c in zip(card, cpu):
            share, off, common, arg = nearest_share(g["keypoints"], c["keypoints"], KP_MATCH_PX)
            shares.append(share)
            offsets.append(off)
            desc_gap = max(desc_gap, float(np.abs(g["descriptors"][common] - c["descriptors"][arg[common]]).max()))
        m_same, m_total = 0, 0
        for a in range(len(card)):
            for b in range(a + 1, len(card)):
                mg = MutualNNMatcher(device=dev)(card[a]["descriptors"], card[b]["descriptors"])["matches0"]
                mc = MutualNNMatcher(device="cpu")(card[a]["descriptors"], card[b]["descriptors"])["matches0"]
                m_same += int((mg == mc).sum())
                m_total += len(mg)
        shutil.copytree(Path(tmp) / "scene" / "cache", Path(tmp) / "cache_cpu")
        runs["cpu"] = run_pipeline(Path(tmp) / "scene", E2E_CONF, "cpu", cache_dir=Path(tmp) / "cache_cpu")
    summ = {}
    for d, (rec, ok, wall) in runs.items():
        summ[d] = dict(ok=ok, registered=sorted(rec.reg_image_ids()), points=rec.num_points3D(),
                       ate=ate_rmse(rec, scene.poses) if rec.num_reg_images() >= 3 else float("inf"), wall=wall)
    g, c = summ["cuda"], summ["cpu"]
    gap = abs(g["points"] - c["points"]) / max(c["points"], 1)
    line = (f"pipeline, small scene ({cfg['n_images']} x {cfg['img_wh'][0]}x{cfg['img_wh'][1]}), card vs CPU: keypoints "
            f"in common (within {KP_MATCH_PX} px) {min(shares):.4f} .. {max(shares):.4f} (bound {KP_COMMON}), largest "
            f"offset {max(offsets):.2e} px, descriptors of common keypoints within {desc_gap:.2e} (bound {DESC_TOL}); matches equal "
            f"{m_same}/{m_total}; mapping from the card's caches: registered {g['registered']} / {c['registered']}, "
            f"points {g['points']} / {c['points']} (gap {gap:.4f}, bound {MAPPING_POINTS_REL}), ATE {g['ate']:.5f} / "
            f"{c['ate']:.5f} (bound {PIPELINE_ATE}), wall {g['wall']:.3f} / {c['wall']:.3f} s")
    print(line)
    if (min(shares) < KP_COMMON or not desc_gap <= DESC_TOL or m_same != m_total or g["registered"] != c["registered"]
            or not gap <= MAPPING_POINTS_REL or not max(g["ate"], c["ate"]) < PIPELINE_ATE
            or len(g["registered"]) < cfg["n_images"] - 1):
        raise AssertionError(line)
    return summ


# ---- the extraction modes off the main path (slice 10): dense NCC matches, dense-anchored matches,
# pair-depth priors, sky masks ----

# (a) the pipeline phase's geometry (640×480, focal 520, baseline 0.18, the wedge) cut to 5 images: 10 pairs,
# at most 4096 dense matches each; mapped under the pipeline conf in the sparse+dense+measured mode with the
# heuristic sky masks, after a warm-up on its first 2 images (every stage at 640×480)
DENSE = dict(PIPELINE, n_images=5)
DENSE_CONF = {**PIPELINE_CONF, "matches_mode": "sparse+dense+measured",
              "extractors": {**PIPELINE_CONF["extractors"], "masks": "heuristic"}}
DENSE_WARM_IMAGES = 2
# its bounds (registered images, ATE, points): the points' floor ~90% of the JAX package's count over the
# same render on the CPU (5/5, 41 124 points, ATE 0.003413; the port on the card: 5/5, 41 349, 0.005082)
DENSE_FULL_BOUNDS = (5, 0.02, 37000)
# (b) the dense-anchored matcher in the sparse+measured mode and (c) the pair-depth mode, on the small
# scene under the e2e conf: >= n - 1 registered (tests/test_dense_retrieval_masks.py's and
# tests/test_pipeline_e2e.py's bounds); the anchored matches' share within ANCHOR_FLOW_PX of their
# pair's median flow above ANCHOR_INLIERS (test_dense_anchored_sparse_mode's)
ANCHOR_CONF = {**E2E_CONF, "extractors": {**E2E_CONF["extractors"], "matcher": "dense_anchor"}}
PAIR_DEPTH_CONF = {**E2E_CONF, "matches_mode": "sparse+measured+depth"}
ANCHOR_INLIERS, ANCHOR_FLOW_PX = 0.6, 15.0
# (d) card against CPU: the NCC flows equal at NCC_FLOW_SHARE of the grid, the certainty within
# NCC_CERT_TOL where they are; masks equal at MASK_SHARE of the pixels; the net's input within
# SESSION_TOL (the CPU tests' bounds against the JAX package)
NCC_FLOW_SHARE, NCC_CERT_TOL, MASK_SHARE, SESSION_TOL = 0.99, 1e-5, 0.999, 1e-4
# the full phase, and its rehearsal on the CPU at small sizes
DENSE_SIZES = {
    "full": dict(scene=DENSE, warm=DENSE_WARM_IMAGES, bounds=DENSE_FULL_BOUNDS, small=PIPELINE_SMALL,
                 sky_hw=(480, 640), onnx_hw=(701, 800)),
    "small": dict(scene=dict(PIPELINE_SMALL, n_images=3, img_wh=(160, 120), focal=130.0), warm=2,
                  bounds=(3, PIPELINE_ATE, 300), small=dict(PIPELINE_SMALL, n_images=4, img_wh=(160, 120), focal=130.0),
                  sky_hw=(120, 160), onnx_hw=(641, 700)),
}


class FakeSkySession:
    """tests/test_dense_retrieval_masks.py's stand-in for an onnxruntime
    session of the sky net: the onnxruntime interface, the probability the
    mean of the input's channels (bright rows are sky); keeps its input."""

    class _Input:
        name = "input"

    def __init__(self):
        self.seen = None

    def get_inputs(self):
        return [self._Input()]

    def run(self, outputs, feed):
        x = feed["input"]
        if x.shape != (1, 3, 320, 320) or x.dtype != np.float32:
            raise AssertionError(f"sky net input {x.shape} {x.dtype}")
        self.seen = x
        return [x[0].mean(0)[None, None]]


def sky_image(rng, hw):
    """(H, W, 3) float32 image: a bright-blue band on top of a textured ground."""
    H, W = hw
    img = rng.uniform(0, 0.5, (H, W, 3)).astype(np.float32)
    band = H // 3
    img[:band] = np.array([0.5, 0.6, 0.9], np.float32) + rng.normal(0, 0.003, (band, W, 3)).astype(np.float32)
    return img


def onnx_image(rng, hw):
    """The fake session's test image: (H, W, 3) uint8, bright sky above dark ground."""
    H, W = hw
    img = np.zeros((H, W, 3), np.uint8)
    img[: 3 * H // 7] = 235
    img[3 * H // 7:] = 40
    return np.clip(img + rng.integers(0, 8, img.shape), 0, 255).astype(np.uint8)


def anchored_inlier_share(cache, conf):
    """Share of the dense-anchored matches of every pair within
    ANCHOR_FLOW_PX (both axes) of their pair's median flow, and the
    matches' count."""
    from pathlib import Path

    from mpsfm_tpu_torch.utils import io

    fmt = conf["cache_format"]
    feats = io.store_path(cache, f"feats-{conf['extractors']['features']}", fmt)
    anchored = io.store_path(cache, "matches-dense_ncc-anchored", fmt)
    inl, n = 0, 0
    for a, b in io.read_pairs(Path(cache) / "pairs.txt"):
        m, _ = io.get_matches(anchored, a, b)
        if len(m) == 0:
            continue
        flow = io.get_keypoints(feats, b)[m[:, 1]] - io.get_keypoints(feats, a)[m[:, 0]]
        inl += int((np.abs(flow - np.median(flow, axis=0)) < ANCHOR_FLOW_PX).all(1).sum())
        n += len(m)
    return inl / max(n, 1), n


def dense_full_run(dev, counted, size):
    """(a): the sparse+dense+measured mode with sky masks over the full
    render, a warm-up on its first images, then measured with the launch
    counts at 0. Returns (summary, launches, kept kernel arguments, the
    map); the summary holds the first two images, gray in [0, 1]
    ("pair")."""
    import shutil
    import tempfile
    from pathlib import Path

    from mpsfm_tpu_torch.utils import io
    from mpsfm_tpu_torch.utils.profiling import TIMERS

    cfg = dict(size["scene"])
    min_reg, ate_bound, min_points = size["bounds"]
    with tempfile.TemporaryDirectory() as tmp:
        scene = render_rgbd_dir(Path(tmp) / "scene", **cfg)
        shutil.copytree(Path(tmp) / "scene", Path(tmp) / "warm")
        for i in range(size["warm"], cfg["n_images"]):
            (Path(tmp) / "warm" / "images" / f"im{i:02d}.png").unlink()
            (Path(tmp) / "warm" / "depth" / f"im{i:02d}.npy").unlink()
        _, _, warm_s = run_pipeline(Path(tmp) / "warm", DENSE_CONF, dev)
        TIMERS.reset()
        for k in counted.values():
            k.launches = 0
        with devices_seen(dense=True) as seen, path_kernel_args() as kept:
            rec, ok, wall = run_pipeline(Path(tmp) / "scene", DENSE_CONF, dev)
        launches = {name: k.launches for name, k in counted.items()}
        pipe = {k: round(v, 4) for k, v in TIMERS.totals.items() if k.startswith("pipe.")}
        ate = ate_rmse(rec, scene.poses) if rec.num_reg_images() >= 3 else float("inf")
        gap = check_written_model(rec, Path(tmp) / "scene" / "sfm_outputs")
        cache = Path(tmp) / "scene" / "cache"
        dense = io.store_path(cache, "dense-dense_ncc", DENSE_CONF["cache_format"])
        per_pair = [len(io.get_dense_pair(dense, a, b)[2]) for a, b in io.read_pairs(cache / "pairs.txt")]
        with io.open_store(io.store_path(cache, "masks", DENSE_CONF["cache_format"])) as f:
            sky = {n: round(float(1 - np.asarray(f[n]).mean()), 4) for n in f.keys()}
        pair = [io.read_image(Path(tmp) / "scene" / "images" / f"im{i:02d}.png", True).astype(np.float32) / 255.0
                for i in (0, 1)]
    out = dict(ok=bool(ok), registered=rec.num_reg_images(), images=rec.num_images(), points=rec.num_points3D(),
               ate=ate, wall=wall, frames_per_s=rec.num_images() / wall, pipe=pipe, devices=seen,
               dense_per_pair=per_pair, warm_s=warm_s, pair=pair)
    print(f"dense modes (a): {cfg['n_images']} PNG images {cfg['img_wh'][0]}x{cfg['img_wh'][1]} (the pipeline phase's "
          f"geometry), sparse+dense+measured, heuristic sky masks; warm-up run ({size['warm']} images) {warm_s:.3f} s wall")
    print(f"dense modes (a): {wall:.3f} s wall, {out['frames_per_s']:.4f} frames/s; registered {out['registered']}/"
          f"{out['images']} (bound {min_reg}); {out['points']} points (bound {min_points}); ATE {ate:.6f} (bound "
          f"{ate_bound}); written model read back, pose gap {gap:.2e}; dense matches a pair {per_pair} (sum "
          f"{sum(per_pair)}); sky share of each mask {json.dumps(sky)}; devices "
          f"{json.dumps({k: sorted(v) for k, v in seen.items()})}; launches {json.dumps(launches)}")
    print(f"dense modes (a) pipe.* phases (s wall): {json.dumps(pipe)}")
    print("dense modes (a) phase timers (s wall x calls):\n" + TIMERS.summary())
    if any(v != {dev.type} for v in seen.values()):
        raise AssertionError(f"dense modes (a): stages off the device: {seen}")
    if unlaunched(launches):
        raise AssertionError(f"kernels {unlaunched(launches)} were not launched in the dense modes phase")
    if not (ok and out["registered"] >= min_reg and ate < ate_bound and out["points"] >= min_points):
        raise AssertionError(f"dense modes (a): {out} (bounds: >= {min_reg} registered, ATE < {ate_bound}, >= "
                             f"{min_points} points)")
    return out, launches, kept, rec


def dense_small_modes(dev, size):
    """(b) the dense-anchored matcher and (c) the pair-depth mode on the
    small scene. Returns their summaries."""
    import tempfile
    from pathlib import Path

    from mpsfm_tpu_torch.utils import io

    cfg = dict(size["small"])
    res = {}
    for what, conf in (("anchored", ANCHOR_CONF), ("pair depth", PAIR_DEPTH_CONF)):
        with tempfile.TemporaryDirectory() as tmp:
            scene = render_rgbd_dir(Path(tmp) / "scene", **cfg)
            rec, ok, wall = run_pipeline(Path(tmp) / "scene", conf, dev)
            cache = Path(tmp) / "scene" / "cache"
            r = dict(ok=bool(ok), registered=rec.num_reg_images(), points=rec.num_points3D(), wall=wall,
                     ate=ate_rmse(rec, scene.poses) if rec.num_reg_images() >= 3 else float("inf"))
            if what == "anchored":
                r["inlier_share"], r["matches"] = anchored_inlier_share(cache, conf)
                held = r["inlier_share"] > ANCHOR_INLIERS
            else:
                with io.open_store(io.store_path(cache, "pair-depth-dense_ncc", conf["cache_format"])) as f:
                    r["depth_entries"] = sum(1 for a in f.keys() for b in f[a].keys() for n in f[a][b].keys()
                                             if "depth" in f[a][b][n])
                held = r["depth_entries"] > 0
        res[what] = r
        print(f"dense modes ({'b' if what == 'anchored' else 'c'}) {what}, {cfg['n_images']} images "
              f"{cfg['img_wh'][0]}x{cfg['img_wh'][1]}: {json.dumps(r)}")
        if not (ok and r["registered"] >= cfg["n_images"] - 1 and held):
            raise AssertionError(f"dense modes, {what}: {r} (bounds: >= {cfg['n_images'] - 1} registered, "
                                 f"inlier share > {ANCHOR_INLIERS} / pair depths written)")
    return res


def dense_card_vs_cpu(dev, size, pair):
    """(d) the NCC flow of one pair of (a)'s images, the sky heuristic and
    the onnx path (the fake session) on the card and on the CPU; on the
    card, the NCC flow, a heuristic mask, a guided upsample and a pyrDown
    ladder timed. Returns the numbers."""
    import torch

    from mpsfm_tpu_torch.extraction.guided_filter import guided_upsample
    from mpsfm_tpu_torch.extraction.masks import (SkyMask, close5, pyr_down_ladder, sky_candidates,
                                                  sky_mask_heuristic, top_connected)
    from mpsfm_tpu_torch.extraction.matchers.dense_ncc import ncc_flow

    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED + 13)
    A, B = (torch.as_tensor(im) for im in pair)
    fg = [t.cpu() for t in ncc_flow(A.to(dev), B.to(dev))]
    fc = ncc_flow(A, B)
    same = (fg[1] == fc[1]).all(1)
    cert_gap = float((fg[2] - fc[2])[same].abs().max())
    share = float(same.double().mean())
    img = sky_image(rng, size["sky_hw"])
    mg, mc = sky_mask_heuristic(img, device=dev).cpu(), sky_mask_heuristic(img, device=cpu)
    sky_share = float((mg == mc).double().mean())
    onnx = onnx_image(rng, size["onnx_hw"])
    sess = {d.type: FakeSkySession() for d in (dev, cpu)}
    og, oc = (SkyMask({"backend": "onnx"}, session=sess[d.type], device=d)(onnx) for d in (dev, cpu))
    onnx_share = float((og == oc).mean())
    in_gap = float(np.abs(sess[dev.type].seen - sess["cpu"].seen).max())
    out = dict(ncc_share=share, ncc_cert_gap=cert_gap, ncc_grid=int(same.numel()), sky_share=sky_share,
               onnx_share=onnx_share, session_gap=in_gap, sky_of_onnx=float(1 - og.mean()))
    if dev.type == "cuda":
        Ad, Bd = A.to(dev), B.to(dev)
        imd = torch.as_tensor(img, device=dev)
        cand = sky_candidates(imd)
        top = top_connected(cand)
        ref = torch.as_tensor(onnx, device=dev).to(torch.float64) / 255.0
        prob = torch.as_tensor(sess[dev.type].seen[0].mean(0), device=dev)
        ud = torch.as_tensor(onnx, device=dev)
        out["ms"] = {"ncc_flow": cuda_ms(lambda: ncc_flow(Ad, Bd), 5),
                     "sky_mask_heuristic": cuda_ms(lambda: sky_mask_heuristic(imd), 10),
                     # the heuristic's parts: the filters and rules, the flood fill, the close
                     "sky.candidates": cuda_ms(lambda: sky_candidates(imd), 10),
                     "sky.top_connected": cuda_ms(lambda: top_connected(cand), 10),
                     "sky.close5": cuda_ms(lambda: close5(top), 10),
                     "guided_upsample": cuda_ms(lambda: guided_upsample(ref, prob, 256), 5),
                     "pyr_down_ladder": cuda_ms(lambda: pyr_down_ladder(ud), 10)}
    print(f"dense modes (d), card vs CPU: NCC flow of one {A.shape[1]}x{A.shape[0]} pair, flows equal at {share:.6f} "
          f"of {out['ncc_grid']} grid points (bound {NCC_FLOW_SHARE}), certainty within {cert_gap:.2e} where equal "
          f"(bound {NCC_CERT_TOL}); sky heuristic at {size['sky_hw'][1]}x{size['sky_hw'][0]} equal at {sky_share:.6f} "
          f"(bound {MASK_SHARE}); onnx path (fake session) at {size['onnx_hw'][1]}x{size['onnx_hw'][0]}: mask equal "
          f"at {onnx_share:.6f} (bound {MASK_SHARE}), net input within {in_gap:.2e} (bound {SESSION_TOL}), sky "
          f"{out['sky_of_onnx']:.4f}; device ms {json.dumps(out.get('ms'))}")
    if not (share >= NCC_FLOW_SHARE and cert_gap <= NCC_CERT_TOL and sky_share >= MASK_SHARE
            and onnx_share >= MASK_SHARE and in_gap <= SESSION_TOL):
        raise AssertionError(f"dense modes (d), card vs CPU: {out}")
    return out


def dense_modes_phase(dev, counted, size="full"):
    """The extraction modes off the main path on the card: (a) the port's
    reconstruct in the sparse+dense+measured mode with heuristic sky masks
    over DENSE (5 images of 640×480), after a warm-up on its first 2 images,
    with the launch counts at 0 just before: every stage on the card (the
    NCC flow and the masks too), each kernel launched, DENSE_FULL_BOUNDS,
    the written model read back; each kernel held to its plain version at
    the run's shapes (check_path_kernels); (b) the dense-anchored matcher
    and (c) the pair-depth mode on the small scene; (d) the NCC flow, the
    sky heuristic and the onnx path card against CPU, timed on the card.
    size: "full", or "small" for a rehearsal on the CPU (counted {}).
    Returns (summary, launches, the K1 row at the run's reduced system)."""
    import torch

    dev = torch.device(dev)
    size = DENSE_SIZES[size]
    out, launches, kept, rec = dense_full_run(dev, counted, size)
    k1 = None
    if dev.type == "cuda":
        out["kernel_ms"] = check_path_kernels("dense modes phase", kept, rec, dev)
        S, b = kept["K1"]["args"]
        k1 = k1_row(S, b, f"K1 at the dense modes phase's last global BA (K={S.shape[0]})")
        print(k1["line"])
    del kept, rec
    out["small"] = dense_small_modes(dev, size)
    out["card_vs_cpu"] = dense_card_vs_cpu(dev, size, out.pop("pair"))
    return out, launches, k1


# ---- the flagship neural extraction (slice 11): SuperPoint, LightGlue on K4, NetVLAD, Metric3Dv2 ----

# configs/sp-lg_m3dv2-small.yaml as the port's load_cfg gives it (tests/test_torch_pipeline_neural.py holds
# it equal), with NetVLAD retrieval, the directory store and one card (dist_ba off); the phase adds the
# weights paths of its seeded checkpoints
NEURAL_CONF = {"matches_mode": "sparse",
               "extractors": {"features": "superpoint", "matcher": "lightglue", "depth": "metric3dv2-small",
                              "pairs_type": "retrieval", "n_retrieval": 20, "retrieval": "netvlad",
                              "feature_conf": {"weights_path": None, "max_keypoints": 6000, "nms_radius": 4,
                                               "resize_max": 1600},
                              "matcher_conf": {"weights_path": None}},
               "image_priors": {"depth": {"depth_uncertainty": 0.0433, "prior_std_multiplier": 2.045}},
               "cache_format": "npy", "mapper": {"ba": {"dist_ba": "off"}}}
# The nets at full width: SuperPoint (the config's 6000 keypoints, NMS radius 4, threshold 0.005), LightGlue
# 9 × 256 × 4 heads, NetVLAD K = 64, D = 512 with its 4096-wide whitening at resize_max 640, Metric3Dv2-small
# at its 616×1064 crop; giant2 once, weights drawn on the card. The pipeline render cut to 5 images of
# 640×480. Card against CPU: SuperPoint on one image, NetVLAD on one image, LightGlue in float32 on one pair
# with each image's first cpu_keypoints keypoints (bucket 1024, not the run's 8192) and Metric3Dv2-small at
# the crop cpu_crop (308×532, a quarter of the pixels), cut so that the CPU's forwards stay a small share
# of the phase. "small": a rehearsal on the CPU at narrow widths (no manifest check below
# the official sizes, as in either package; the NetVLAD whitening a zero-stride tensor, so its file stays
# small).
NEURAL_SIZES = {
    "full": dict(render=dict(PIPELINE, n_images=5), sp={}, lg={},
                 netvlad=dict(K=64, resize_max=640, whiten_random=True),
                 m3d=dict(encoder="vit_small_reg"), m3d_tiny={}, giant2=True, cpu_keypoints=1024,
                 cpu_crop=(308, 532), k4_small_bucket=2048),
    "small": dict(render=dict(PIPELINE_SMALL, n_images=3), sp=dict(max_keypoints=512),
                  lg=dict(dim=64, num_heads=4, n_layers=2, input_dim=256),
                  netvlad=dict(K=64, resize_max=160, whiten_random=False),
                  m3d=dict(encoder="vit_small_reg"),
                  m3d_tiny=dict(dim=32, depth=4, heads=2, hooks=(0, 1, 2, 3), feature_channels=(8, 12, 16, 16),
                                decoder_channels=(8, 8, 12, 16, 16), hidden=8, iters=2, crop_size=(112, 112),
                                pos_grid=8),
                  giant2=False, cpu_keypoints=256, cpu_crop=(112, 112), k4_small_bucket=512),
}
# card against CPU: keypoints as sets (KP_MATCH_PX, KP_COMMON), descriptors within DESC_TOL (the CPU tests'
# bounds against the JAX package), LightGlue's mutual-argmax matches equal at KP_COMMON or more, the NetVLAD
# descriptor within NETVLAD_TOL of its largest entry, Metric3Dv2's depth and normals within M3D_REL of their
# largest magnitude. LightGlue's float32 scores within DESC_TOL times their largest magnitude: the official
# 9 layers on seeded weights carry float32's summation order from layer to layer, and the card running the
# plain attention lies as far from the CPU as with K4 (2.59e-4 and 2.61e-4 at scores up to 17.5, H100); K4's
# run is held within DESC_TOL of that plain-attention run's distance.
NETVLAD_TOL, M3D_REL = 1e-4, 1e-3
# K4 against attention_plain: float32 within K4_TOL (the JAX package's own bound between its attention paths,
# tests/test_extraction.py); bfloat16 (the tensor-core route, which rounds P to bfloat16 for P·V as the JAX
# package's bfloat16 paths do) within k4_bf16_bound: 2u times the plain version on |v| (each weight's rounding
# moves its term by at most u of its size), one bfloat16 ulp of the plain result (the output's rounding) and
# K4_TOL (float32's summation order), u = 2^-8 bfloat16's unit roundoff
K4_TOL = 2e-5
BF16_U = 2.0 ** -8
# (d) on the card: the mapping pair's matches take the mapper to at least its initial pair
NEURAL_MIN_REG = 2
# (a): LightGlue's bfloat16 matches0 with K4 against the plain attention on the card, the share of equal entries;
# the JAX package's own bfloat16 run agrees with its float32 one on 99.54% (tests/test_torch_lightglue.py)
LG_BF16_AGREE = 0.99
PEAK_BF16 = 989e12  # the H100 SXM's dense bfloat16 tensor-core rate: K4's bound for bfloat16 inputs


def neural_checkpoints(d, size, seed=SEED + 13):
    """Seeded checkpoints in the official layouts, on the host: superpoint_v1.pth,
    superpoint_lightglue.pth, metric_depth_vit_small_800k.pth (depth_model.
    prefixes) and a NetVLAD torch export (backbone.N, netvlad.*, whiten.*,
    preproc_mean). And (d)'s pair, in the same layouts, so that matches
    reach the mapper: a superpoint_v1.pth drawn He-normal (std
    sqrt(2 / fan_in)) with zero biases and every filter but the detector's
    (convPb) zero-mean, so that no response follows its input's mean (the
    seeded net's uniform ±1/sqrt(fan_in) draws lose the image over its eight
    convolutions: its descriptors agree to a cosine of 0.9999, so no matcher
    tells them apart; these agree to 0.11 on average, and about half of the
    matches below lie within 3 px of the truth); and the identity-block LightGlue of
    tests/test_torch_pipeline_neural.py: each block's last FFN layer zeroed
    (a block returns its input), input_proj the identity, final_proj 80·I,
    matchability 1, so the descriptors reach the dual softmax unchanged (the
    seeded net's scores sit near 1/N² and keep no match). Returns {role:
    path} and the seconds it took."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.extraction.features.superpoint import CONVS, SuperPoint
    from mpsfm_tpu_torch.extraction.matchers.lightglue import LightGlue
    from mpsfm_tpu_torch.extraction.nets.metric3d import Metric3Dv2
    from mpsfm_tpu_torch.extraction.retrieval import _CONV_IDX, NetVLAD

    t = time.perf_counter()
    d.mkdir(parents=True, exist_ok=True)
    (d / "mapping").mkdir(exist_ok=True)
    paths = {"features": d / "superpoint_v1.pth", "matcher": d / "superpoint_lightglue.pth",
             "features_mapping": d / "mapping" / "superpoint_v1.pth",
             "matcher_mapping": d / "mapping" / "superpoint_lightglue.pth",
             "depth": d / "metric_depth_vit_small_800k.pth", "retrieval": d / "netvlad_pitts30k.pth"}
    sp = SuperPoint(device="cpu")
    sp.init_random(seed)
    torch.save(sp.net.state_dict(), paths["features"])
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name in CONVS:
        w = sp.net.state_dict()[f"{name}.weight"]
        w = torch.randn(w.shape, generator=g) * (2 / w[0].numel()) ** 0.5
        sd[f"{name}.weight"] = w if name == "convPb" else w - w.mean((1, 2, 3), keepdim=True)
        sd[f"{name}.bias"] = torch.zeros(w.shape[0])
    torch.save(sd, paths["features_mapping"])
    lg = LightGlue(size["lg"], device="cpu")
    lg.init_random(seed)
    L, p = lg.conf["n_layers"], lg.params
    torch.save(convert.lightglue_state_dict(p, L), paths["matcher"])
    for blk in [f"{kind}_{l}" for l in range(L) for kind in ("self", "cross")]:
        p[blk]["ffn1"]["w"].zero_()
        p[blk]["ffn1"]["b"].zero_()
    p["input_proj"]["w"] = torch.eye(*p["input_proj"]["w"].shape)
    p["final_proj"]["w"] = 80 * torch.eye(*p["final_proj"]["w"].shape)
    p["matchability"]["w"].zero_()
    p["matchability"]["b"].fill_(10)
    torch.save(convert.lightglue_state_dict(p, L), paths["matcher_mapping"])
    m3d = Metric3Dv2({**size["m3d"], **size["m3d_tiny"]}, device="cpu")
    torch.save({"depth_model." + k: v for k, v in m3d.init_random(seed).items()}, paths["depth"])
    nv = NetVLAD(device="cpu")
    K = size["netvlad"]["K"]
    nv.init_random(seed, K=K, D=512)
    p = nv.params
    sd = {f"backbone.{ti}.{s}": p[f"conv{i}"][n] for i, ti in enumerate(_CONV_IDX) for s, n in (("weight", "w"),
                                                                                                 ("bias", "b"))}
    sd["netvlad.score_proj.weight"] = p["assign_w"][:, :, None]
    sd["netvlad.centers"] = p["centers"].T.contiguous()
    g = torch.Generator().manual_seed(seed)
    sd["whiten.weight"] = (torch.randn(4096, K * 512, generator=g) * (K * 512) ** -0.5
                           if size["netvlad"]["whiten_random"] else torch.zeros(1).expand(4096, K * 512))
    sd["whiten.bias"] = torch.zeros(4096)
    sd["preproc_mean"] = torch.tensor([123.68, 116.779, 103.939])
    torch.save(sd, paths["retrieval"])
    return paths, time.perf_counter() - t


def neural_conf(paths, size, mapping=False):
    """NEURAL_CONF with the checkpoints' paths (SuperPoint's and LightGlue's
    the mapping pair with `mapping`) and the size's widths."""
    conf = json.loads(json.dumps(NEURAL_CONF))
    ex = conf["extractors"]
    tag = "_mapping" if mapping else ""
    ex["feature_conf"].update(weights_path=str(paths["features" + tag]), **size["sp"])
    ex["matcher_conf"].update(weights_path=str(paths["matcher" + tag]), **size["lg"])
    ex["depth_conf"] = {"weights_path": str(paths["depth"]), **size["m3d_tiny"]}
    ex["retrieval_conf"] = {"weights_path": str(paths["retrieval"]), "resize_max": size["netvlad"]["resize_max"]}
    return conf


def neural_images(data_dir):
    """The render's images as the extraction reads them: gray in [0, 1], RGB uint8."""
    from pathlib import Path

    from mpsfm_tpu_torch.utils.io import read_image

    paths = sorted((Path(data_dir) / "images").iterdir())
    return ([read_image(p, True).astype(np.float32) / 255 for p in paths], [read_image(p) for p in paths])


def attention_spy():
    """Context manager keeping the arguments of LightGlue's first self- and
    first cross-attention call of each (bucket, dtype) (calls 0 and 2 of a
    forward) and counting forwards. Yields (kept, forwards)."""
    from mpsfm_tpu_torch.extraction.matchers import lightglue

    kept, calls, forwards = {}, [0], [0]
    orig_att, orig_fwd = lightglue.attention, lightglue.LightGlue.forward

    def att(q, k, v, mask, scale):
        i = calls[0]
        calls[0] += 1
        if i in (0, 2):
            kept.setdefault((("self", "cross")[i // 2], q.shape[1], q.dtype), (q, k, v, mask, scale))
        return orig_att(q, k, v, mask, scale)

    def fwd(self, *a):
        forwards[0] += 1
        calls[0] = 0
        return orig_fwd(self, *a)

    @contextlib.contextmanager
    def ctx():
        lightglue.attention, lightglue.LightGlue.forward = att, fwd
        try:
            yield kept, forwards
        finally:
            lightglue.attention, lightglue.LightGlue.forward = orig_att, orig_fwd

    return ctx()


def neural_full_width(dev, paths, size, images, rgbs, intr):
    """(a) the nets at full width on `dev`, loaded through the port's
    loaders from the checkpoints (manifest-checked at the official sizes):
    SuperPoint on every image, LightGlue on every pair of them in bfloat16
    and float32 (timed per pair, at the run's bucket and at a smaller one),
    NetVLAD on every image, Metric3Dv2-small on every image, giant2 once.
    Returns the features, LightGlue's kept attention arguments and the
    times."""
    import torch

    from mpsfm_tpu_torch.extraction.features.superpoint import SuperPoint
    from mpsfm_tpu_torch.extraction.matchers.lightglue import LightGlue
    from mpsfm_tpu_torch.extraction.nets.metric3d import Metric3Dv2
    from mpsfm_tpu_torch.extraction.retrieval import NetVLAD

    out = {}
    conf = neural_conf(paths, size)["extractors"]
    sp = SuperPoint(conf["feature_conf"], device=dev)
    sp.batch(images[:1])  # warm-up
    sync(dev)
    t = time.perf_counter()
    feats = sp.batch(images)
    sync(dev)
    out["superpoint_s"] = (time.perf_counter() - t) / len(images)
    out["keypoints"] = [len(f["keypoints"]) for f in feats]
    table = [(f["keypoints"], f["descriptors"]) for f in feats]
    whs = [im.shape[::-1] for im in images]
    pairs = [(a, b) for a in range(len(images)) for b in range(a + 1, len(images))]
    cut = size["k4_small_bucket"]
    small = [(f["keypoints"][:cut], f["descriptors"][:cut]) for f in feats[:2]]
    kept_all, lg_times, k4_launches = {}, {}, {}
    for dt in ("bfloat16", "float32"):
        lg = LightGlue({**conf["matcher_conf"], "dtype": dt}, device=dev)
        lg.match_pairs_from_table(table[:2], whs[:2], [(0, 1)])  # warm-up
        with attention_spy() as (kept, forwards):
            for k in k4_kernels():
                k.launches = 0
            sync(dev)
            t = time.perf_counter()
            res = lg.match_pairs_from_table(table, whs, pairs)
            sync(dev)
            wall = time.perf_counter() - t
            k4_launches[dt] = {k.name: k.launches for k in k4_kernels()}
            k4_launches[dt]["forwards"] = forwards[0]
            t = time.perf_counter()
            lg.match_pairs_from_table(small, whs[:2], [(0, 1)])
            sync(dev)
            wall_small = time.perf_counter() - t
        kept_all.update(kept)
        lg_times[dt] = {LightGlue._bucket(max(out["keypoints"])): wall / len(pairs),
                        LightGlue._bucket(max(len(k) for k, _ in small)): wall_small}
        out[f"matches_{dt}"] = [int((r["matches0"] >= 0).sum()) for r in res]
        out[f"forwards_{dt}"] = forwards[0]
    out["lightglue_s_per_pair"] = lg_times
    out["k4_launches"] = k4_launches
    # the seeded SuperPoint's descriptors are nearly equal (a cosine of 0.9999), so its matches are ties that any
    # rounding flips; the agreement runs on (d)'s He-normal SuperPoint's features of the same images
    sp_m = SuperPoint(neural_conf(paths, size, mapping=True)["extractors"]["feature_conf"], device=dev)
    table_m = [(f["keypoints"], f["descriptors"]) for f in sp_m.batch(images)]
    del sp_m
    out["bf16_agreement"] = lightglue_bf16_agreement(dev, conf["matcher_conf"], table_m, whs, pairs)
    nv = NetVLAD(conf["retrieval_conf"], device=dev)
    nv(rgbs[0])
    sync(dev)
    t = time.perf_counter()
    descs = [nv(im) for im in rgbs]
    sync(dev)
    out["netvlad_s"] = (time.perf_counter() - t) / len(rgbs)
    out["netvlad_finite"] = bool(np.isfinite(np.stack(descs)).all())
    m3d = Metric3Dv2({**size["m3d"], **size["m3d_tiny"], "weights_path": conf["depth_conf"]["weights_path"]},
                     device=dev)
    m3d.infer_image(rgbs[0], intr)
    sync(dev)
    t = time.perf_counter()
    maps = [m3d.infer_image(im, intr) for im in rgbs]
    sync(dev)
    out["metric3d_s"] = (time.perf_counter() - t) / len(rgbs)
    out["metric3d_ok"] = all(m["depth"].shape == rgbs[0].shape[:2] and np.isfinite(m["depth"]).all()
                             and m["normals"].shape == (*rgbs[0].shape[:2], 3) for m in maps)
    out["metric3d_patches"] = tuple(c // m3d.conf["patch"] for c in m3d.conf["crop_size"])
    del m3d
    if size["giant2"]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        g2 = Metric3Dv2({"encoder": "vit_giant2_reg"}, device=dev)
        params = g2.init_random(SEED + 14, on_device=True)
        sync(dev)
        out["giant2_init_s"] = time.perf_counter() - t
        out["giant2_params"] = sum(v.numel() for v in params.values())
        t = time.perf_counter()
        m = g2.infer_image(rgbs[0], intr)
        sync(dev)
        out["giant2_s"] = time.perf_counter() - t
        out["giant2_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["giant2_ok"] = bool(m["depth"].shape == rgbs[0].shape[:2] and np.isfinite(m["depth"]).all()
                                and np.isfinite(m["normals"]).all())
        del g2, params
        torch.cuda.empty_cache()
    # on the card each type's LightGlue reaches its own kernel only, 36 times a forward
    dispatch_ok = dev.type != "cuda" or all(
        k4_launches[dt][own] == 36 * k4_launches[dt]["forwards"] > 0 and k4_launches[dt][other] == 0
        for dt, own, other in (("bfloat16", "attention_tc", "attention"), ("float32", "attention", "attention_tc")))
    out["ok"] = (out["netvlad_finite"] and out["metric3d_ok"] and out.get("giant2_ok", True) and dispatch_ok
                 and out["bf16_agreement"]["share"] >= LG_BF16_AGREE)
    return feats, kept_all, out


def k4_kernels():
    """K4's two kernels: the float32 one and the tensor-core bfloat16 one."""
    from mpsfm_tpu_torch.extraction.matchers import attention as att

    return att.KERNEL, att.KERNEL_TC


def lightglue_bf16_agreement(dev, matcher_conf, table, whs, pairs):
    """The seeded LightGlue (every mutual argmax kept: filter_threshold 0)
    on `pairs` of the feature `table`: in bfloat16 once with K4 and once
    with the plain attention, and in float32, on the same device. Returns
    the share of matches0 entries the two bfloat16 runs agree on (held),
    the share the plain bfloat16 run agrees with the float32 one on
    (bfloat16's own spread, printed), the entries and the matched ones."""
    from mpsfm_tpu_torch.extraction.matchers import attention as att
    from mpsfm_tpu_torch.extraction.matchers import lightglue

    runs = {}
    for name, dt in (("k4", "bfloat16"), ("plain", "bfloat16"), ("float32", "float32")):
        lg = lightglue.LightGlue({**matcher_conf, "dtype": dt, "filter_threshold": 0.0}, device=dev)
        if name == "plain":
            lightglue.attention = att.attention_plain
        try:
            runs[name] = np.concatenate([r["matches0"] for r in lg.match_pairs_from_table(table, whs, pairs)])
        finally:
            lightglue.attention = att.attention
    k4, plain = runs["k4"], runs["plain"]
    matched = (k4 >= 0) | (plain >= 0)
    return dict(share=float((k4 == plain).mean()), share_bf16_f32=float((plain == runs["float32"]).mean()),
                entries=int(k4.size), matches_k4=int((k4 >= 0).sum()), matches_plain=int((plain >= 0).sum()),
                matched=int(matched.sum()), matched_equal=int((k4 == plain)[matched].sum()))


def neural_card_vs_cpu(dev, size, images=None, rgbs=None, intr=None):
    """(b) each net on `dev` and on the CPU from the same seeded weights, on
    one image or pair: SuperPoint (keypoints as sets within KP_MATCH_PX, at
    least KP_COMMON common, descriptors within DESC_TOL), LightGlue in
    float32 on the first cpu_keypoints keypoints of two images (scores
    within DESC_TOL, mutual-argmax matches equal at KP_COMMON or more),
    NetVLAD (within NETVLAD_TOL), Metric3Dv2-small at the crop cpu_crop
    (depth and normals within M3D_REL). Renders its own images when none
    are given. Returns the gaps and "ok"."""
    import tempfile
    from pathlib import Path

    import torch

    from mpsfm_tpu_torch.extraction.features.superpoint import SuperPoint
    from mpsfm_tpu_torch.extraction.matchers.lightglue import LightGlue, normalize_keypoints
    from mpsfm_tpu_torch.extraction.nets.metric3d import Metric3Dv2
    from mpsfm_tpu_torch.extraction.retrieval import NetVLAD

    dev = torch.device(dev)
    if images is None:
        with tempfile.TemporaryDirectory() as tmp:
            render_rgbd_dir(Path(tmp) / "scene", **size["render"])
            images, rgbs = neural_images(Path(tmp) / "scene")
        cfg = size["render"]
        intr = (cfg["focal"], cfg["focal"], cfg["img_wh"][0] / 2, cfg["img_wh"][1] / 2)
    out = {}
    sp = SuperPoint(size["sp"], device=dev)
    sp.init_random(SEED + 15)
    g, f1 = sp.batch(images[:2])
    sp = SuperPoint(size["sp"], device="cpu")
    sp.init_random(SEED + 15)
    c = sp(images[0])
    share, off, common, arg = nearest_share(g["keypoints"], c["keypoints"], KP_MATCH_PX)
    out["sp_share"], out["sp_offset"] = share, off
    out["sp_desc_gap"] = float(np.abs(g["descriptors"][common] - c["descriptors"][arg[common]]).max())
    # LightGlue in float32 on the card's features, cut, through the same padded batch on both devices
    f0 = g
    n = size["cpu_keypoints"]
    wh = images[0].shape[::-1]
    b = LightGlue._bucket(n)
    arrs = []
    for f in (f0, f1):
        k = np.zeros((1, b, 2), np.float32)
        dsc = np.zeros((1, b, f["descriptors"].shape[1]), np.float32)
        m = np.zeros((1, b), bool)
        kk = f["keypoints"][:n]
        k[0, :len(kk)] = normalize_keypoints(kk, wh)
        dsc[0, :len(kk)] = f["descriptors"][:n]
        m[0, :len(kk)] = True
        arrs.append((k, dsc, m))
    (k0, d0, m0), (k1, d1, m1) = arrs
    from mpsfm_tpu_torch.extraction.matchers import attention as att
    from mpsfm_tpu_torch.extraction.matchers import lightglue

    lg_out = {}
    for d, name in ((dev, dev.type), (torch.device("cpu"), "cpu"), (dev, "plain")):
        lg = LightGlue({**size["lg"], "dtype": "float32", "filter_threshold": 0.0}, device=d)
        lg.init_random(SEED + 16)
        args = [torch.as_tensor(a, device=d) for a in (k0, k1, d0, d1, m0, m1)]
        if name == "plain":  # the card with the plain attention: K4's share of the gap
            lightglue.attention = att.attention_plain
        try:
            scores = lg.forward(*args)
            mm, _ = lg.forward_extract(*args)
        finally:
            lightglue.attention = att.attention
        lg_out[name] = (scores[0, :int(m0.sum()), :int(m1.sum())].cpu(), mm[0, :int(m0.sum())].cpu())
    (sg, mg), (sc, mc) = lg_out[dev.type], lg_out["cpu"]
    out["lg_score_gap"] = float((sg - sc).abs().max())
    out["lg_score_max"] = float(sc.abs().max())
    out["lg_plain_gap"] = float((lg_out["plain"][0] - sc).abs().max())
    out["lg_match_share"] = float((mg == mc).double().mean())
    out["lg_matches"] = int((mc >= 0).sum())
    descs = {}
    for d in (dev, torch.device("cpu")):
        nv = NetVLAD({"resize_max": size["netvlad"]["resize_max"]}, device=d)
        nv.init_random(SEED + 17, K=size["netvlad"]["K"])
        descs[d.type] = nv(rgbs[0])
    out["netvlad_gap"] = float(np.abs(descs[dev.type] - descs["cpu"]).max() / np.abs(descs["cpu"]).max())
    maps = {}
    for d in (dev, torch.device("cpu")):
        m3d = Metric3Dv2({**size["m3d"], **size["m3d_tiny"], "crop_size": size["cpu_crop"]}, device=d)
        m3d.init_random(SEED + 18)
        maps[d.type] = m3d.infer_image(rgbs[0], intr)
    gm, cm = maps[dev.type], maps["cpu"]
    out["m3d_depth_rel"] = float(np.abs(gm["depth"] - cm["depth"]).max() / np.abs(cm["depth"]).max())
    out["m3d_normals_rel"] = float(np.abs(gm["normals"] - cm["normals"]).max() / np.abs(cm["normals"]).max())
    out["ok"] = bool(out["sp_share"] >= KP_COMMON and out["sp_desc_gap"] <= DESC_TOL
                     and out["lg_score_gap"] <= DESC_TOL * max(1.0, out["lg_score_max"])
                     and out["lg_score_gap"] <= out["lg_plain_gap"] + DESC_TOL and out["lg_match_share"] >= KP_COMMON
                     and out["netvlad_gap"] <= NETVLAD_TOL and out["m3d_depth_rel"] <= M3D_REL
                     and out["m3d_normals_rel"] <= M3D_REL)
    return out


def bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significand bits)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


def k4_bf16_bound(q, k, v, mask, scale):
    """K4's bfloat16 rule on (q, k, v, mask, scale): the plain version's
    float32 result on those inputs and the bound on |K4 - plain| per
    element, 2u · attention_plain(q, k, |v|) + one bfloat16 ulp of the
    plain result + K4_TOL. Returns (plain, bound)."""
    from mpsfm_tpu_torch.extraction.matchers import attention as att

    qf, kf, vf = q.float(), k.float(), v.float()
    plain = att.attention_plain(qf, kf, vf, mask, scale)
    return plain, 2 * BF16_U * att.attention_plain(qf, kf, vf.abs(), mask, scale) + bf16_ulp(plain) + K4_TOL


def k4_check(what, args, reps=10):
    """K4 against attention_plain on `args` (q, k, v, mask, scale), through
    the wrapper, which must launch the dtype's kernel once: float32 (the
    CUDA-core kernel) within K4_TOL, bfloat16 (the tensor-core kernel)
    within k4_bf16_bound; K4, the plain version and the library call
    (scaled_dot_product_attention with the key mask, timed only) timed on
    the card; the bound from the FLOP over the real keys (at the float32 or
    the bfloat16 tensor-core peak) and the bytes. Returns a row dict."""
    import torch
    import torch.nn.functional as F

    from mpsfm_tpu_torch.extraction.matchers import attention as att

    q, k, v, mask, scale = args
    kernel = att.KERNEL if q.dtype == torch.float32 else att.KERNEL_TC
    n = kernel.launches
    got = att.attention(q, k, v, mask, scale)
    torch.cuda.synchronize()
    if kernel.launches != n + 1:
        raise AssertionError(f"{what}: K4 ({kernel.name}) was not launched")
    if q.dtype == torch.float32:
        ref = att.attention_plain(q, k, v, mask, scale)
        err = float((got - ref).abs().max())
        ok, bound_txt = err <= K4_TOL, f"max |d| <= {K4_TOL}"
    else:
        ref, bound = k4_bf16_bound(q, k, v, mask, scale)
        d = (got.float() - ref).abs()
        err, ratio = float(d.max()), float((d / bound).max())
        ok, bound_txt = ratio <= 1, f"at most {ratio:.3f} of 2u·plain(|v|) + ulp + {K4_TOL}"
        del bound, d
    if not ok or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: K4 vs plain max |d| {err:.3e} ({bound_txt})")
    del ref
    ms = cuda_ms(lambda: att.attention(q, k, v, mask, scale), reps)
    kernel.launches = n  # launches made to compare and time K4 are not the path's
    plain_ms = cuda_ms(lambda: att.attention_plain(q, k, v, mask, scale), 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    am = mask[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, scale=scale), reps)
    B, N, H, hd = q.shape
    flops = att.attention_flops(N, H, hd, mask)  # the real keys only: a masked key's weight is 0
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + mask.numel()
    peak = PEAK_F32 if q.dtype == torch.float32 else PEAK_BF16
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    line = (f"{what}: K4 ({kernel.name}) {ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound "
            f"{max(ops_ms, bytes_ms):.4f} ms ({'operations' if ops_ms >= bytes_ms else 'bytes'}, "
            f"{flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s; {max(ops_ms, bytes_ms) / ms * 100:.1f}% of it), "
            f"{flops / ms / 1e9:.2f} TFLOP/s achieved; max |d| {err:.3e} ({bound_txt})")
    print(line)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops_ms=ops_ms, bytes_ms=bytes_ms, line=line,
                shape=f"{B}x{N}x{H}x{hd}")


def k4_phase(dev, kept, size):
    """(c) K4 against attention_plain at the shapes the phase's LightGlue
    ran: its first self- and cross-attention call of each bucket and type
    (kept by attention_spy), and at hd = 16 (the tests' LightGlue) on seeded
    inputs at the smaller bucket. Returns {(kind, bucket, dtype): row}."""
    import torch

    rows = {}
    for (kind, bucket, dt), args in sorted(kept.items(), key=lambda x: (-x[0][1], x[0][0], str(x[0][2]))):
        B, N, H, hd = args[0].shape
        rows[(kind, bucket, str(dt).split(".")[-1])] = k4_check(
            f"K4 {kind}-attention at bucket {bucket} ({B}x{N}x{H}x{hd} against {args[1].shape[1]} keys, "
            f"{int(args[3][0].sum())} real), {str(dt).split('.')[-1]}", args)
    rng = np.random.default_rng(SEED + 19)
    b = size["k4_small_bucket"]
    mask = torch.as_tensor(np.arange(b)[None] < b - 37, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.as_tensor(rng.normal(size=(1, b, 4, 16)), dtype=torch.float32, device=dev).to(dt)
                   for _ in range(3))
        rows[("hd16", b, str(dt).split(".")[-1])] = k4_check(
            f"K4 at hd = 16 (1x{b}x4x16, {b - 37} real keys), {str(dt).split('.')[-1]}", (q, k, v, mask, 0.25))
    return rows


@contextlib.contextmanager
def neural_seen():
    """Record the pipeline's neural models as it builds them and the device
    of each stage's work: the detector's images, the matcher's operands,
    NetVLAD's images, Metric3Dv2's crops, verification and the mapper.
    Yields (seen: stage -> set of device types, models: role -> list)."""
    import torch

    from mpsfm_tpu_torch import pipeline
    from mpsfm_tpu_torch.extraction import base, priors
    from mpsfm_tpu_torch.extraction.features.superpoint import SuperPoint
    from mpsfm_tpu_torch.extraction.matchers.lightglue import LightGlue
    from mpsfm_tpu_torch.extraction.nets.metric3d import Metric3Dv2
    from mpsfm_tpu_torch.extraction.retrieval import NetVLAD
    from mpsfm_tpu_torch.scene import correspondences

    seen = {k: set() for k in ("features", "matches", "retrieval", "depth", "populate", "mapper")}
    models = {"features": [], "matcher": [], "retrieval": [], "depth": []}
    orig = dict(batch_fn=SuperPoint.batch_fn, fwd=LightGlue.forward, nv=NetVLAD.forward, m3d=Metric3Dv2.forward,
                be=priors._Metric3DBackend, verify=correspondences.estimate_two_view_geometry_batch,
                mapper=pipeline.MpsfmMapper, fm=dict(base.FEATURE_MODELS), mm=dict(base.MATCHER_MODELS),
                nvc=base.NetVLAD)

    def batch_fn(self):
        fn = orig["batch_fn"](self)

        def run(x):
            seen["features"].add(x.device.type)
            return fn(x)

        return run

    def fwd(self, k0, *a):
        seen["matches"].add(k0.device.type)
        return orig["fwd"](self, k0, *a)

    def nv_fwd(self, img):
        seen["retrieval"].add(img.device.type)
        return orig["nv"](self, img)

    def m3d_fwd(self, p, x, hw):
        seen["depth"].add(x.device.type)
        return orig["m3d"](self, p, x, hw)

    def recorder(cls, role):
        def make(*a, **k):
            m = cls(*a, **k)
            models[role].append(m)
            return m

        return make

    def verify(pairs, *a, device, **k):
        seen["populate"].add(torch.device(device).type)
        return orig["verify"](pairs, *a, device=device, **k)

    def mapper(*a, **k):
        m = orig["mapper"](*a, **k)
        seen["mapper"] |= {m.optimizer.device.type, m.registration.device.type, m.dc.device.type}
        return m

    SuperPoint.batch_fn, LightGlue.forward, NetVLAD.forward, Metric3Dv2.forward = batch_fn, fwd, nv_fwd, m3d_fwd
    base.FEATURE_MODELS["superpoint"] = recorder(SuperPoint, "features")
    base.MATCHER_MODELS["lightglue"] = recorder(LightGlue, "matcher")
    base.NetVLAD = recorder(NetVLAD, "retrieval")
    priors._Metric3DBackend = recorder(orig["be"], "depth")
    correspondences.estimate_two_view_geometry_batch, pipeline.MpsfmMapper = verify, mapper
    try:
        yield seen, models
    finally:
        SuperPoint.batch_fn, LightGlue.forward, NetVLAD.forward, Metric3Dv2.forward = (
            orig["batch_fn"], orig["fwd"], orig["nv"], orig["m3d"])
        base.FEATURE_MODELS.update(orig["fm"])
        base.MATCHER_MODELS.update(orig["mm"])
        base.NetVLAD, priors._Metric3DBackend = orig["nvc"], orig["be"]
        correspondences.estimate_two_view_geometry_batch, pipeline.MpsfmMapper = orig["verify"], orig["mapper"]


def tensors_of(model):
    """Every tensor a neural model holds (its net's parameters or its param dict)."""
    import torch

    found = []

    def walk(x):
        if torch.is_tensor(x):
            found.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    net = getattr(model, "net", None)
    if isinstance(net, torch.nn.Module):
        found += list(net.parameters())
    elif net is not None:  # the Metric3Dv2 backend: its net's param dict
        walk(net.params)
    walk(getattr(model, "params", None))
    return found


def neural_pipeline(dev, counted, size, paths, data_dir):
    """(d) the port's reconstruct under NEURAL_CONF with the checkpoints over
    the render (the mapping pair of checkpoints: a He-normal SuperPoint and
    the identity-block LightGlue, so matches reach the mapper), the launch
    counts at 0 just before. Held: the run reaches its
    end; every net's tensors and every stage's work on `dev`; the pairs from
    NetVLAD's descriptors; the feature, match and depth stores written; the
    depth store equal to a direct infer_image; K4's tensor-core kernel
    launched 36 times a (bfloat16) LightGlue forward and the float32 one
    not at all; on the card, matches kept, at least NEURAL_MIN_REG images
    registered with points, K1 and K2 launched. Not held (seeded weights):
    how many images register, the points' count, ATE. Prints each pipe.*
    phase's wall, the matches a pair and the launches."""
    from pathlib import Path

    import torch

    from mpsfm_tpu_torch.extraction.pairs import pairs_from_retrieval
    from mpsfm_tpu_torch.utils import io
    from mpsfm_tpu_torch.utils.profiling import TIMERS

    conf = neural_conf(paths, size, mapping=True)
    TIMERS.reset()
    for k in counted.values():
        k.launches = 0
    with neural_seen() as (seen, models), attention_spy() as (_, forwards):
        rec, ok, wall = run_pipeline(data_dir, conf, dev)
    launches = {name: k.launches for name, k in counted.items()}
    pipe = {k: round(v, 4) for k, v in TIMERS.totals.items() if k.startswith("pipe.")}
    cache = Path(data_dir) / "cache"
    names = sorted(p.name for p in (Path(data_dir) / "images").iterdir())
    stores = {"features": cache / "feats-superpoint.npyd", "matches": cache / "matches-lightglue.npyd",
              "depth": cache / "depth-metric3dv2-small.npyd", "pairs": cache / "pairs.txt"}
    written = {k for k, p in stores.items() if p.exists()}
    pairs = io.read_pairs(stores["pairs"])
    nv = models["retrieval"][0]
    descs = np.stack([nv(io.read_image(Path(data_dir) / "images" / n)) for n in names])
    pairs_from = "netvlad" if pairs == pairs_from_retrieval(names, descs, conf["extractors"]["n_retrieval"],
                                                             device=dev) else "other"
    be = models["depth"][0]
    intr = json.loads((Path(data_dir) / "intrinsics.yaml").read_text())["1"]["params"]
    direct = be.net.infer_image(io.read_image(Path(data_dir) / "images" / names[0]), intr)
    stored = io.get_mono_map(stores["depth"], names[0])
    depth_gap = float(np.abs(stored["depth"] - direct["depth"]).max() / np.abs(direct["depth"]).max())
    per_pair = [int((io.get_matches(stores["matches"], a, b)[0]).shape[0]) for a, b in pairs]
    on_dev = {role: sorted({t.device.type for m in ms for t in tensors_of(m)}) for role, ms in models.items()}
    out = dict(reached_end=True, ok=bool(ok), registered=rec.num_reg_images(), images=rec.num_images(),
               points=rec.num_points3D(), wall=wall, pipe=pipe, stores=written, pairs_from=pairs_from,
               depth_gap=depth_gap, depth_equal=depth_gap <= 1e-5, matches_per_pair=per_pair,
               forwards=forwards[0], tensors=on_dev, seen={k: sorted(v) for k, v in seen.items()})
    print(f"neural pipeline (sp-lg_m3dv2-small + NetVLAD, the mapping SuperPoint and LightGlue, {len(names)} "
          f"images {size['render']['img_wh'][0]}x{size['render']['img_wh'][1]}): {wall:.3f} s wall, reached its end; "
          f"registered {out['registered']}/{out['images']} (held >= {NEURAL_MIN_REG} on the card), {out['points']} "
          f"points (count not held: seeded weights); {len(pairs)} pairs from "
          f"{pairs_from}; matches a pair {per_pair}; stores {sorted(written)}; depth store vs a direct infer_image "
          f"{depth_gap:.2e}; LightGlue forwards {forwards[0]}; tensors on {json.dumps(on_dev)}; stages on "
          f"{json.dumps(out['seen'])}; launches {json.dumps(launches)}")
    print(f"neural pipeline pipe.* phases (s wall): {json.dumps(pipe)}")
    want = torch.device(dev).type
    problems = []
    if written != set(stores) or pairs_from != "netvlad" or not out["depth_equal"]:
        problems.append("stores / pairs / depth")
    # every net's tensors and every stage that ran on the device; the nets and the mapper ran
    ran = {"features", "matches", "retrieval", "depth", "mapper"}
    if (any(v != [want] for v in on_dev.values()) or any(v and v != [want] for v in out["seen"].values())
            or not all(out["seen"][k] for k in ran)):
        problems.append(f"off {want}")
    # the conf's bfloat16 LightGlue: every attention call on the tensor-core kernel, none on the float32 one
    if want == "cuda" and (forwards[0] == 0 or launches.get("attention_tc") != 36 * forwards[0]
                           or launches.get("attention") != 0):
        problems.append(f"K4 launches {launches.get('attention_tc')} (tensor cores) and {launches.get('attention')} "
                        f"(float32) for {forwards[0]} bfloat16 forwards")
    if want == "cuda" and (not any(per_pair) or out["registered"] < NEURAL_MIN_REG or out["points"] == 0
                           or unlaunched({k: launches.get(k, 0) for k in (*K1_ROUTES, "bini")})):
        problems.append(f"the mapper on the neural matches: registered {out['registered']}, {out['points']} "
                        f"points, launches {launches}")
    if problems:
        raise AssertionError(f"neural pipeline: {problems}: {out}")
    return out, launches


def neural_phase(dev, counted, size="full"):
    """Slice 11, the flagship neural extraction: seeded checkpoints in the
    official layouts written and loaded through the port's loaders; (a) the
    nets at full width on the card (neural_full_width), (b) each net card
    against CPU (neural_card_vs_cpu), (c) K4 against attention_plain at
    the shapes LightGlue ran (k4_phase), (d) the port's reconstruct under
    configs/sp-lg_m3dv2-small.yaml with NetVLAD retrieval
    (neural_pipeline). size: "full", or "small" for a rehearsal on the CPU
    (counted {}; no K4 check). Returns (summary, launches, K4 rows)."""
    import tempfile
    from pathlib import Path

    import torch

    dev = torch.device(dev)
    size_name, size = size, NEURAL_SIZES[size]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths, ckpt_s = neural_checkpoints(Path(tmp) / "weights", size)
        data = Path(tmp) / "scene"
        render_rgbd_dir(data, **size["render"])
        cfg = size["render"]
        intr = (cfg["focal"], cfg["focal"], cfg["img_wh"][0] / 2, cfg["img_wh"][1] / 2)
        images, rgbs = neural_images(data)
        feats, kept, full = neural_full_width(dev, paths, size, images, rgbs, intr)
        lgt = full["lightglue_s_per_pair"]
        print(f"neural extraction ({size_name}): checkpoints written in {ckpt_s:.2f} s; SuperPoint "
              f"{full['superpoint_s'] * 1e3:.2f} ms an image ({full['keypoints']} keypoints); LightGlue s a pair "
              + ", ".join(f"{dt} " + " / ".join(f"bucket {b}: {s * 1e3:.2f} ms" for b, s in v.items())
                          for dt, v in lgt.items())
              + f" (matches bf16 {full['matches_bfloat16']}, f32 {full['matches_float32']}); NetVLAD "
              f"{full['netvlad_s'] * 1e3:.2f} ms an image; Metric3Dv2-small {full['metric3d_s'] * 1e3:.2f} ms an "
              f"image ({full['metric3d_patches'][0]}x{full['metric3d_patches'][1]} patches)"
              + (f"; giant2 ({full['giant2_params'] / 1e9:.3f} B params, drawn on the card in "
                 f"{full['giant2_init_s']:.2f} s) {full['giant2_s']:.3f} s wall, peak {full['giant2_peak_gb']:.2f} GB"
                 if size["giant2"] else ""))
        ag = full["bf16_agreement"]
        print(f"neural extraction K4 launches by LightGlue type (each type's timed run): "
              f"{json.dumps(full['k4_launches'])}; LightGlue bfloat16 matches0 on (d)'s SuperPoint features with K4 "
              f"vs the plain attention on {dev.type}, every mutual argmax kept: {ag['share']:.4%} of {ag['entries']} "
              f"entries equal (bound {LG_BF16_AGREE:.0%}; the plain bfloat16 run vs float32 {ag['share_bf16_f32']:.4%}),"
              f" matches {ag['matches_k4']} / {ag['matches_plain']}, of the {ag['matched']} entries matched in "
              f"either run {ag['matched_equal']} equal")
        if not full["ok"]:
            raise AssertionError(f"neural full width: {full}")
        vs = neural_card_vs_cpu(dev, size, images, rgbs, intr)
        print(f"neural card vs CPU: SuperPoint keypoints in common {vs['sp_share']:.4f} (bound {KP_COMMON}), largest "
              f"offset {vs['sp_offset']:.2e} px, descriptors {vs['sp_desc_gap']:.2e} (bound {DESC_TOL}); LightGlue "
              f"float32 at {size['cpu_keypoints']} keypoints: scores {vs['lg_score_gap']:.2e} (bound {DESC_TOL} x max "
              f"|score| {vs['lg_score_max']:.4g}; the card with the plain attention {vs['lg_plain_gap']:.2e}), "
              f"matches equal {vs['lg_match_share']:.4f} ({vs['lg_matches']} mutual); NetVLAD {vs['netvlad_gap']:.2e} "
              f"(bound {NETVLAD_TOL}); Metric3Dv2-small at {size['cpu_crop']}: depth {vs['m3d_depth_rel']:.2e}, "
              f"normals {vs['m3d_normals_rel']:.2e} (bound {M3D_REL})")
        if not vs["ok"]:
            raise AssertionError(f"neural card vs CPU: {vs}")
        k4 = k4_phase(dev, kept, size) if dev.type == "cuda" else {}
        del kept
        pipe, launches = neural_pipeline(dev, counted, size, paths, data)
    print(f"neural extraction phase: {time.perf_counter() - t0:.1f} s wall")
    return dict(full=full, card_vs_cpu=vs, pipeline=pipe, launches=launches), launches, k4


# ---- the paper's nets (slice 14): DSINE normals and the RoMa dense matcher ----


def merge_conf(a, b):
    """a with b merged in, key by key, into its nested dicts (a copy)."""
    out = json.loads(json.dumps(a))
    for k, v in b.items():
        out[k] = merge_conf(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


# configs/paper/sp-lg_m3dv2.yaml and configs/sp-roma-dense_m3dv2.yaml as the port loads them, cut as the neural
# phase's (d) cuts sp-lg_m3dv2: Metric3Dv2-small with its calibration (sp-lg_m3dv2-small.yaml), the directory
# store, dist_ba off; the configs' own grid retrieval (no NetVLAD)
PAPER_BASE = json.loads(json.dumps(NEURAL_CONF))
del PAPER_BASE["extractors"]["retrieval"]
PAPER_LG_CONF = merge_conf(PAPER_BASE, {"extractors": {"normals": "dsine-kappa-fc"},
                                        "image_priors": {"normals": {"flip_consistency": True}}})
ROMA_DENSE_CONF = merge_conf(PAPER_BASE, {"matches_mode": "sparse+dense", "extractors": {
    "matcher": "nn", "dense_matcher": "roma",
    "dense_matcher_conf": {"weights_path": None, "dinov2_weights_path": None, "mode": "sparse+dense"}}})
# The nets at full width: DSINE-B5 (the official dsine.pth layout) on the neural phase's render (5 images of
# 640×480), RoMa (roma_outdoor.pth + dinov2_vitl14_pretrain.pth, ViT-L/14) at its 672² working resolution on each
# pair of them. Card against CPU cut: DSINE-B5 on one image cut to cpu_hw (a quarter of the pixels), RoMa on one
# pair at cpu_resolution (16² coarse tokens, K = 256 for the GP, instead of 48²), so that the CPU's forwards stay
# a small share of the phase. The reconstructs (d) on the render's first pipeline_images images (cut from 5 since
# slice 15, so that the whole script stays within its time). "small": a rehearsal on the CPU at tests/test_dsine.py's
# and tests/test_roma.py's TINY widths.
PAPER_SIZES = {
    "full": dict(neural="full", dsine={}, roma={}, cpu_hw=(240, 320), cpu_resolution=224, pipeline_images=3),
    "small": dict(neural="small",
                  dsine=dict(stages=((1, 8, 1, 1, 3), (6, 12, 1, 2, 3), (6, 16, 1, 2, 5), (6, 16, 1, 2, 3),
                                     (6, 24, 2, 2, 5)), stem=8, head=32, decoder_nf=16, feature_dim=8,
                             hidden_dim=8, iters=2),
                  roma=dict(vit_dim=32, vit_depth=2, vit_heads=2, vit_patch=14, pos_grid=8, gp_dim=8, feat_dim=8,
                            dec_blocks=2, dec_heads=2, cls_res=8, kernel_T=0.2, sigma_noise=0.1,
                            vgg_spec=(("C", 4), "M", ("C", 6), "M", ("C", 8), "M", ("C", 12), "M"),
                            scales=(("16", 32, 8, 4, 2, 1, True), ("8", 12, 8, 4, 1, 1, True),
                                    ("4", 8, 6, 2, 0, 1, True), ("2", 6, 4, 2, 0, 1, True),
                                    ("1", 4, 3, 2, 0, 1, False)), resolution=112),
                  cpu_hw=(120, 160), cpu_resolution=224, pipeline_images=3),
}
# card against CPU: DSINE's normals within M3D_REL (absolute: unit vectors) and its variance within M3D_REL of its
# largest value (float32's summation order through the encoder's 39 blocks and the 5 GRU steps); RoMa's flow within
# ROMA_FLOW_TOL ([-1, 1] units: 0.08 px at 224²) and certainty logits within ROMA_FLOW_TOL of their largest
# magnitude on at least KP_COMMON of the pixels (the anchor classifier's argmax flips a cell on float32 ties)
ROMA_FLOW_TOL = 1e-3


def seeded_state_dict(shapes, seed, dev):
    """An official-layout state dict (CPU tensors) of seeded draws on `dev`
    for {name: shape}: biases and running means 0, norm and BatchNorm
    weights and LayerScale gammas 1, running variances |1 + 0.1 n|, the
    class token and position embedding 0.02 n, every other weight n /
    sqrt(fan_in) (fan_in: the product of its dimensions after the first),
    so that activations keep their scale through the nets' depth."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    sd = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "running_mean"):
            v = torch.zeros(shape, device=dev)
        elif leaf == "running_var":
            v = (1 + 0.1 * torch.randn(shape, generator=g, device=dev)).abs()
        elif leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
            v = torch.ones(shape, device=dev)
        elif leaf in ("cls_token", "pos_embed"):
            v = 0.02 * torch.randn(shape, generator=g, device=dev)
        else:
            v = torch.randn(shape, generator=g, device=dev) * float(np.prod(shape[1:])) ** -0.5
        sd[name] = v.cpu()
    return sd


def paper_checkpoints(d, size, dev, seed=SEED + 20):
    """dsine.pth, roma_outdoor.pth and dinov2_vitl14_pretrain.pth in the
    official layouts (seeded_state_dict, drawn on `dev`) at the size's
    widths: at full width the pinned manifests' names and shapes, at small
    those of the port's nets at the tiny configs. Returns {role: path} and
    the seconds it took."""
    import torch

    from mpsfm_tpu_torch.extraction.manifest import load_manifest
    from mpsfm_tpu_torch.extraction.nets.dsine import DSINE
    from mpsfm_tpu_torch.extraction.nets.roma import RomaNet

    t = time.perf_counter()
    d.mkdir(parents=True, exist_ok=True)
    if size["neural"] == "full":
        shapes, outdoor, dinov2 = (load_manifest(n) for n in ("dsine", "roma-outdoor", "roma-dinov2"))
    else:
        shapes = {k: tuple(v.shape) for k, v in DSINE(size["dsine"], device="cpu").init_random(0).items()}
        roma = {k: tuple(v.shape) for k, v in RomaNet(size["roma"], device="cpu").init_random(0).items()}
        outdoor = {k: v for k, v in roma.items() if not k.startswith("dinov2.")}
        dinov2 = {k[len("dinov2."):]: v for k, v in roma.items() if k.startswith("dinov2.")}
    paths = {"dsine": d / "dsine.pth", "roma": d / "roma_outdoor.pth", "dinov2": d / "dinov2_vitl14_pretrain.pth"}
    torch.save(seeded_state_dict(shapes, seed, dev), paths["dsine"])
    torch.save(seeded_state_dict(outdoor, seed + 1, dev), paths["roma"])
    torch.save({"model": seeded_state_dict(dinov2, seed + 2, dev)}, paths["dinov2"])  # the official file's nesting
    return paths, time.perf_counter() - t


def paper_nets_full_width(dev, paths, size, rgbs, grays, intr):
    """(a) DSINE and RoMa at full width on `dev`, loaded through the port's
    loaders (manifest-checked at the official sizes): DSINE on every image,
    one pass and the flipped pair; RoMa on every pair of the gray images as
    Extraction hands them, timed by stage (the VGG pyramid, DINOv2, the
    projections, the GP with its K1 many launch, the match decoder with
    the anchor classifier, the refiners), its K1 many launches counted (one
    a pair) and the GP's last K_bb and right-hand sides kept. Returns the
    summary and the kept (K_bb, f). Its DINOv2's attention is K4 float32
    (24 launches a forward at the official depth): those launches are
    counted too, and the last call's arguments kept (summary["k4_args"])."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky
    from mpsfm_tpu_torch.extraction.matchers import attention as att
    from mpsfm_tpu_torch.extraction.nets import roma
    from mpsfm_tpu_torch.extraction.nets.dsine import DSINE

    out = {}
    net = DSINE({**size["dsine"], "weights_path": str(paths["dsine"])}, device=dev)
    net.infer_image(rgbs[0], intr)  # warm-up
    sync(dev)
    for what, flips in (("dsine_s", (False,)), ("dsine_pair_s", (False, True))):
        t = time.perf_counter()
        maps = [net.infer_image(im, intr, flip=f) for im in rgbs for f in flips]
        sync(dev)
        out[what] = (time.perf_counter() - t) / len(rgbs)
    out["dsine_ok"] = all(m["normals"].shape == (*rgbs[0].shape[:2], 3) and np.isfinite(m["normals"]).all()
                          and np.abs(np.linalg.norm(m["normals"], axis=-1) - 1).max() < 1e-4
                          and (m["normals_variance"] > 0).all() for m in maps)
    out["dsine_params"] = sum(v.numel() for v in net.params.values())
    del net, maps
    m = roma.RomaMatcher({**size["roma"], "weights_path": str(paths["roma"]),
                          "dinov2_weights_path": str(paths["dinov2"])}, device=dev)
    out["roma_params"] = sum(v.numel() for v in m.net.params.values())
    m(grays[0], grays[1])  # warm-up
    sync(dev)
    pairs = [(a, b) for a in range(len(grays)) for b in range(a + 1, len(grays))]
    times = {}
    n0, k0 = cholesky.KERNEL_MANY.launches, att.KERNEL.launches
    with last_call(roma, "cholesky_solve", lambda a, out: a[0].shape[0]) as kept, \
            last_call(roma, "multi_head", lambda a, out: 0) as kept_k4:
        t = time.perf_counter()
        res = [m(grays[a], grays[b], times=times) for a, b in pairs]
        sync(dev)
        wall = time.perf_counter() - t
    out["roma_gp_launches"] = cholesky.KERNEL_MANY.launches - n0
    out["roma_k4_launches"] = att.KERNEL.launches - k0
    q, k, v = kept_k4["args"]  # as multi_head takes them: every key real, scale 1/sqrt(hd)
    out["k4_args"] = (q, k, v, torch.ones(k.shape[:2], dtype=torch.bool, device=q.device), q.shape[-1] ** -0.5)
    out["roma_vit_depth"] = m.net.conf["vit_depth"]
    out["roma_s_per_pair"] = wall / len(pairs)
    out["roma_stage_s"] = {k: v / len(pairs) for k, v in times.items()}
    out["roma_matches"] = [len(r["certainty"]) for r in res]
    out["roma_resolution"] = m.resolution
    out["gp_K"], out["gp_N"] = kept["args"][0].shape[0], kept["args"][1].shape[1]
    out["roma_ok"] = all(np.isfinite(r["keypoints1"]).all() and np.isfinite(r["certainty"]).all() for r in res)
    del m
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, (kept["args"][0], kept["args"][1])


def paper_nets_card_vs_cpu(dev, paths, size, rgbs, grays, intr):
    """(b) DSINE and RoMa on `dev` and on the CPU from the same checkpoints,
    cut: DSINE on the first image resized to cpu_hw, both passes (normals
    within M3D_REL, the variance within M3D_REL of its largest value);
    RoMa's forward on the first pair at cpu_resolution (flow within
    ROMA_FLOW_TOL and certainty logits within ROMA_FLOW_TOL of their
    largest magnitude on at least KP_COMMON of the pixels). Returns the gaps
    and "ok"."""
    import torch

    from mpsfm_tpu_torch.extraction.nets.depth_anything import _resize
    from mpsfm_tpu_torch.extraction.nets.dsine import DSINE
    from mpsfm_tpu_torch.extraction.nets.roma import RomaMatcher

    h, w = size["cpu_hw"]
    img = _resize(torch.as_tensor(rgbs[0], dtype=torch.float32)[None], (h, w))[0].numpy()
    sx, sy = w / rgbs[0].shape[1], h / rgbs[0].shape[0]
    cut_intr = (intr[0] * sx, intr[1] * sy, intr[2] * sx, intr[3] * sy)
    maps = {}
    for d in (dev, torch.device("cpu")):
        net = DSINE({**size["dsine"], "weights_path": str(paths["dsine"])}, device=d)
        maps[d.type] = [net.infer_image(img, cut_intr, flip=f) for f in (False, True)]
    out = {"dsine_normals": max(float(np.abs(a["normals"] - b["normals"]).max())
                                for a, b in zip(maps[dev.type], maps["cpu"])),
           "dsine_variance_rel": max(float(np.abs(a["normals_variance"] - b["normals_variance"]).max()
                                           / np.abs(b["normals_variance"]).max())
                                     for a, b in zip(maps[dev.type], maps["cpu"]))}
    fwd = {}
    for d in (dev, torch.device("cpu")):
        m = RomaMatcher({**size["roma"], "resolution": size["cpu_resolution"], "weights_path": str(paths["roma"]),
                         "dinov2_weights_path": str(paths["dinov2"])}, device=d)
        with torch.no_grad():
            xa, xb = (m._prep(g, m.resolution)[0] for g in grays[:2])
            flow, cert = m.net.forward(xa, xb)
        fwd[d.type] = (flow[0].cpu().numpy(), cert[0].cpu().numpy())
    (fg, cg), (fc, cc) = fwd[dev.type], fwd["cpu"]
    dflow = np.abs(fg - fc).max(-1)
    dcert = np.abs(cg - cc)
    agree = (dflow <= ROMA_FLOW_TOL) & (dcert <= ROMA_FLOW_TOL * max(1.0, float(np.abs(cc).max())))
    out.update(roma_share=float(agree.mean()), roma_flow_median=float(np.median(dflow)),
               roma_flow_max=float(dflow.max()), roma_cert_max=float(dcert.max()), roma_res=int(fg.shape[0]))
    out["ok"] = bool(out["dsine_normals"] <= M3D_REL and out["dsine_variance_rel"] <= M3D_REL
                     and out["roma_share"] >= KP_COMMON)
    return out


def k1_many_check_in_situ(S, Bm, what):
    """K1 many on a path's own system (S, Bm) by k1_many_check's float64
    rule, at K1_REL[0.01] unless the plain version itself lies farther than
    that from the float64 solve, then at K1_ILL_REL (as k1_check_in_situ
    decides for K1). Returns (max |ΔX|, a line)."""
    from mpsfm_tpu_torch.ba import cholesky

    rel, res = f64_gaps(S, Bm, cholesky.cholesky_solve_plain(S, Bm))
    bound = K1_REL[0.01] if rel <= K1_REL[0.01] and res <= K1_REL[0.01] else K1_ILL_REL
    return k1_many_check(S, Bm, bound, f"{what}; the plain version {rel:.2e} relative, residual {res:.2e} from the "
                                       "float64 solve", f64=True)


def k1_many_gp(K_bb, f):
    """(c) K1 many against cholesky_solve_plain at the GP's own K_bb and
    right-hand sides (k1_many_check_in_situ), timed beside its plain version
    and two library calls: torch.linalg.cholesky + torch.cholesky_solve (the
    row's) and torch.linalg.solve (the JAX package's LU), and its bound
    (K³/3 + 2K²N FLOP; K_bb, f and the solution once over the memory
    rate). Returns a row dict."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    K, N = f.shape
    err, line = k1_many_check_in_situ(K_bb, f, f"K1 many at the RoMa GP's K_bb (K = {K}, N = {N})")
    ms = cuda_ms(lambda: cholesky.cholesky_solve(K_bb, f), 10)
    plain_ms = cuda_ms(lambda: cholesky.cholesky_solve_plain(K_bb, f), 2)
    lib_ms = cuda_ms(lambda: torch.cholesky_solve(f, torch.linalg.cholesky(K_bb)), 10)
    lu_ms = cuda_ms(lambda: torch.linalg.solve(K_bb, f), 10)
    ops_ms = (K ** 3 / 3 + 2.0 * K * K * N) / PEAK_F32 * 1e3
    bytes_ms = 4.0 * (K * K + 2 * K * N) / PEAK_BYTES * 1e3
    cond = float(torch.linalg.cond(K_bb.double()))
    line += (f"; condition number {cond:.4g}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library (cholesky + "
             f"cholesky_solve) {lib_ms:.4f} ms, torch.linalg.solve {lu_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.5f} "
             f"ms ({'operations' if ops_ms >= bytes_ms else 'bytes'})")
    print(line)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, lu_ms=lu_ms, ops_ms=ops_ms, bytes_ms=bytes_ms)


@contextlib.contextmanager
def paper_nets_seen():
    """Record the DSINE backends and RoMa matchers the pipeline builds and
    the device of each of their forwards, and count the forwards. Yields
    (models: role -> list, seen: role -> set of device types, forwards:
    role -> count)."""
    from mpsfm_tpu_torch.extraction import priors
    from mpsfm_tpu_torch.extraction.nets import dsine, roma

    models, seen = {"normals": [], "dense": []}, {"normals": set(), "dense": set()}
    forwards = {"normals": 0, "dense": 0}
    orig = dict(be=priors._DSINEBackend, matcher=roma.RomaMatcher, dfwd=dsine.DSINE.forward, rfwd=roma.RomaNet.forward)

    def recorder(cls, role):
        def make(*a, **k):
            m = cls(*a, **k)
            models[role].append(m)
            return m

        return make

    def dfwd(self, x, *a, **k):
        seen["normals"].add(x.device.type)
        forwards["normals"] += 1
        return orig["dfwd"](self, x, *a, **k)

    def rfwd(self, xa, *a, **k):
        seen["dense"].add(xa.device.type)
        forwards["dense"] += 1
        return orig["rfwd"](self, xa, *a, **k)

    priors._DSINEBackend, roma.RomaMatcher = recorder(orig["be"], "normals"), recorder(orig["matcher"], "dense")
    dsine.DSINE.forward, roma.RomaNet.forward = dfwd, rfwd
    try:
        yield models, seen, forwards
    finally:
        priors._DSINEBackend, roma.RomaMatcher = orig["be"], orig["matcher"]
        dsine.DSINE.forward, roma.RomaNet.forward = orig["dfwd"], orig["rfwd"]


def paper_conf(base, npaths, ppaths, size):
    """A paper phase conf with the checkpoints' paths: (d)'s mapping pair of
    SuperPoint and LightGlue, Metric3Dv2-small, DSINE where the conf takes
    dsine normals, RoMa where it takes the roma dense matcher."""
    nsize = NEURAL_SIZES[size["neural"]]
    conf = json.loads(json.dumps(base))
    ex = conf["extractors"]
    ex["feature_conf"].update(weights_path=str(npaths["features_mapping"]), **nsize["sp"])
    if ex["matcher"] == "lightglue":
        ex["matcher_conf"].update(weights_path=str(npaths["matcher_mapping"]), **nsize["lg"])
    ex["depth_conf"] = {"weights_path": str(npaths["depth"]), **nsize["m3d_tiny"]}
    if ex.get("normals", "").startswith("dsine"):
        ex["normals_conf"] = {"weights_path": str(ppaths["dsine"]), **size["dsine"]}
    if ex.get("dense_matcher") == "roma":
        ex["dense_matcher_conf"].update(weights_path=str(ppaths["roma"]), dinov2_weights_path=str(ppaths["dinov2"]),
                                        **size["roma"])
    return conf


def paper_pipeline(dev, counted, what, conf, data_dir, n_images):
    """(d) The port's reconstruct under `conf` over a copy of the render's
    first n_images images, the launch counts at 0 just before. Held: it reaches its outputs (the text
    model written and read back equal to the map); the DSINE or RoMa nets it
    builds hold their tensors on `dev` and run their forwards there; the
    depth store keeps DSINE's normals2 (the flip-consistency prior's input)
    where the conf takes them; the dense store holds every pair where the
    conf matches densely, and on the card K1 many launched once a RoMa pair
    by the GP. Not held (seeded weights): registered images, points.
    Returns (summary, launches)."""
    import shutil
    from pathlib import Path

    from mpsfm_tpu_torch.ba import cholesky
    from mpsfm_tpu_torch.extraction.nets import roma
    from mpsfm_tpu_torch.utils import io
    from mpsfm_tpu_torch.utils.profiling import TIMERS

    data = Path(data_dir).parent / what
    shutil.copytree(data_dir, data)
    for img in sorted((data / "images").iterdir())[n_images:]:
        img.unlink()
        (data / "depth" / (img.stem + ".npy")).unlink()
    TIMERS.reset()
    for k in counted.values():
        k.launches = 0
    gp = {"calls": 0, "launches": 0}
    solve = roma.cholesky_solve

    def gp_solve(S, rhs):  # the GP's K1 many launches apart from the point covariances'
        n = cholesky.KERNEL_MANY.launches
        x = solve(S, rhs)
        gp["calls"] += 1
        gp["launches"] += cholesky.KERNEL_MANY.launches - n
        return x

    roma.cholesky_solve = gp_solve
    try:
        with paper_nets_seen() as (models, seen, forwards):
            rec, ok, wall = run_pipeline(data, conf, dev)
    finally:
        roma.cholesky_solve = solve
    launches = {name: k.launches for name, k in counted.items()}
    pipe = {k: round(v, 4) for k, v in TIMERS.totals.items() if k.startswith("pipe.")}
    check_written_model(rec, data / "sfm_outputs")
    cache = data / "cache"
    names = sorted(p.name for p in (data / "images").iterdir())
    pairs = io.read_pairs(cache / "pairs.txt")
    ex = conf["extractors"]
    out = dict(ok=bool(ok), registered=rec.num_reg_images(), images=rec.num_images(), points=rec.num_points3D(),
               wall=wall, pipe=pipe, pairs=len(pairs), gp_calls=gp["calls"], gp_launches=gp["launches"],
               seen={k: sorted(v) for k, v in seen.items()}, forwards=forwards)
    problems = []
    tensors = {role: sorted({t.device.type for m in ms for t in m.net.params.values()}) for role, ms in models.items()}
    out["tensors"] = tensors
    want = {"normals": ex.get("normals", "").startswith("dsine"), "dense": ex.get("dense_matcher") == "roma"}
    for role, used in want.items():
        if used and (tensors[role] != [dev.type] or out["seen"][role] != [dev.type]):
            problems.append(f"{role} off {dev.type}: tensors {tensors[role]}, forwards {out['seen'][role]}")
    if want["normals"]:
        keys = set(io.get_mono_map(cache / "depth-metric3dv2-small.npyd", names[0]))
        out["depth_keys"] = sorted(keys)
        if not {"depth", "normals", "normals2", "normals2_variance"} <= keys:
            problems.append(f"depth store keys {sorted(keys)}")
    if want["dense"]:
        per_pair = [len(io.get_dense_pair(cache / "dense-roma.npyd", a, b)[2]) for a, b in pairs]
        out["dense_per_pair"] = per_pair
        if not any(per_pair) or gp["calls"] != len(pairs):
            problems.append(f"dense pairs {per_pair}, GP solves {gp['calls']} for {len(pairs)} pairs")
        if dev.type == "cuda" and gp["launches"] != gp["calls"]:
            problems.append(f"K1 many launched {gp['launches']} times by {gp['calls']} GP solves")
        depth = models["dense"][0].net.conf["vit_depth"]
        if dev.type == "cuda" and launches.get("attention") != depth * forwards["dense"]:
            problems.append(f"K4 float32 launched {launches.get('attention')} times by {forwards['dense']} RoMa "
                            f"forwards ({depth} DINOv2 blocks each)")
    print(f"paper nets pipeline ({what}, {len(names)} images): {wall:.3f} s wall, reached its outputs; registered "
          f"{out['registered']}/{out['images']}, {out['points']} points (not held: seeded weights); {len(pairs)} "
          f"pairs; " + (f"dense matches a pair {out['dense_per_pair']}; GP solves {gp['calls']}, K1 many launches by "
                        f"the GP {gp['launches']}; RoMa forwards {forwards['dense']}; " if want["dense"] else "")
          + (f"depth store keys {out['depth_keys']}; " if want["normals"] else "")
          + f"tensors on {json.dumps(tensors)}, forwards on {json.dumps(out['seen'])}; launches {json.dumps(launches)}")
    print(f"paper nets pipeline ({what}) pipe.* phases (s wall): {json.dumps(pipe)}")
    if problems:
        raise AssertionError(f"paper nets pipeline ({what}): {problems}: {out}")
    return out, launches


def paper_nets_phase(dev, counted, size="full"):
    """Slice 14, the paper's nets: seeded checkpoints in the official
    layouts (paper_checkpoints; the neural phase's SuperPoint, LightGlue
    and Metric3Dv2-small ones by neural_checkpoints), loaded through the
    port's loaders; (a) DSINE-B5 and RoMa at full width on the card
    (paper_nets_full_width), (b) both card against CPU, cut
    (paper_nets_card_vs_cpu), (c) K1 many at the GP's K_bb (k1_many_gp),
    (d) the port's reconstruct under PAPER_LG_CONF and under
    ROMA_DENSE_CONF on the render's first pipeline_images images
    (paper_pipeline). size: "full", or "small" for a
    rehearsal on the CPU (counted {}; no K1 many check). Returns (summary,
    {run: launches}, the K1 many row or None)."""
    import tempfile
    from pathlib import Path

    import torch

    dev = torch.device(dev)
    size_name, size = size, PAPER_SIZES[size]
    nsize = NEURAL_SIZES[size["neural"]]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        npaths, n_s = neural_checkpoints(Path(tmp) / "weights", nsize)
        ppaths, p_s = paper_checkpoints(Path(tmp) / "weights", size, dev)
        data = Path(tmp) / "scene"
        render_rgbd_dir(data, **nsize["render"])
        cfg = nsize["render"]
        intr = (cfg["focal"], cfg["focal"], cfg["img_wh"][0] / 2, cfg["img_wh"][1] / 2)
        grays, rgbs = neural_images(data)
        full, (K_bb, f) = paper_nets_full_width(dev, ppaths, size, rgbs, grays, intr)
        st = full["roma_stage_s"]
        print(f"paper nets ({size_name}): checkpoints written in {n_s + p_s:.2f} s; DSINE ({full['dsine_params'] / 1e6:.2f}"
              f" M params) {full['dsine_s'] * 1e3:.2f} ms an image, {full['dsine_pair_s'] * 1e3:.2f} ms an image with "
              f"its flipped pass ({cfg['img_wh'][0]}x{cfg['img_wh'][1]}); RoMa ({full['roma_params'] / 1e6:.2f} M "
              f"params) at {full['roma_resolution']}^2 {full['roma_s_per_pair'] * 1e3:.2f} ms a pair: "
              + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in st.items())
              + f" (GP: K = {full['gp_K']}, N = {full['gp_N']}, K1 many launches {full['roma_gp_launches']} for "
              f"{len(full['roma_matches'])} pairs; K4 float32 launches {full['roma_k4_launches']}, "
              f"{full['roma_vit_depth']} a forward); matches a pair {full['roma_matches']}")
        npairs = len(full["roma_matches"])
        if not (full["dsine_ok"] and full["roma_ok"]) or (dev.type == "cuda" and (
                full["roma_gp_launches"] != npairs or full["roma_k4_launches"] != full["roma_vit_depth"] * npairs)):
            raise AssertionError(f"paper nets full width: {full}")
        k4_args = full.pop("k4_args")
        k4 = roma_k4_check(k4_args) if dev.type == "cuda" else None
        del k4_args
        vs = paper_nets_card_vs_cpu(dev, ppaths, size, rgbs, grays, intr)
        print(f"paper nets card vs CPU: DSINE-B5 at {size['cpu_hw'][1]}x{size['cpu_hw'][0]}, both passes: normals "
              f"{vs['dsine_normals']:.2e}, variance {vs['dsine_variance_rel']:.2e} of its largest (bound {M3D_REL}); "
              f"RoMa's forward at {vs['roma_res']}^2: {vs['roma_share']:.4%} of the pixels agree (bound {KP_COMMON}: "
              f"flow within {ROMA_FLOW_TOL}, certainty within {ROMA_FLOW_TOL} x its largest), flow gap median "
              f"{vs['roma_flow_median']:.2e}, max {vs['roma_flow_max']:.2e}, certainty max {vs['roma_cert_max']:.2e}")
        if not vs["ok"]:
            raise AssertionError(f"paper nets card vs CPU: {vs}")
        row = k1_many_gp(K_bb, f) if dev.type == "cuda" else None
        del K_bb, f
        runs, launches = {}, {}
        for what, base in (("paper sp-lg_m3dv2", PAPER_LG_CONF), ("sp-roma-dense_m3dv2", ROMA_DENSE_CONF)):
            runs[what], launches[what] = paper_pipeline(dev, counted, what, paper_conf(base, npaths, ppaths, size),
                                                        data, size["pipeline_images"])
    print(f"paper nets phase: {time.perf_counter() - t0:.1f} s wall")
    return dict(full=full, card_vs_cpu=vs, pipelines=runs, k4=k4), launches, row


def roma_k4_check(args):
    """K4 float32 at RoMa's DINOv2 attention (both images batched, 16 heads
    of 64, every key real) by k4_check, and beside it the torch ops it
    replaced in extraction/nets/roma._vit_block (matmul, softmax, matmul on
    (B, heads, n, hd)), timed only. Returns k4_check's row with
    "roma_ops_ms"."""
    import torch

    q, k, v, mask, scale = args
    B, N, H, hd = q.shape
    row = k4_check(f"K4 at RoMa's DINOv2 attention ({B}x{N}x{H}x{hd} against {k.shape[1]} keys, all real), float32",
                   args)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row["roma_ops_ms"] = cuda_ms(lambda: torch.softmax((qt @ kt.transpose(-1, -2)) * scale, -1) @ vt, 10)
    print(f"RoMa's DINOv2 attention as torch ops (matmul + softmax + matmul, before it moved onto K4): "
          f"{row['roma_ops_ms']:.4f} ms; K4 {row['ms']:.4f} ms")
    return row


# ---- the two-view nets (slice 15): MASt3R, the two-view and warp classes, DepthAnythingV2 ----

# configs/sp-mast3r.yaml, sp-mast3r-dense.yaml and sp-lg_dav2.yaml as the port loads them, with the cuts of the
# earlier neural phases: the directory store, dist_ba off, and the Metric3Dv2 normals (metric3dv2-normals, giant2)
# cut to Metric3Dv2-small
TWO_VIEW_CUTS = {"extractors": {"normals_conf": {"encoder": "vit_small_reg"}}, "cache_format": "npy",
                 "mapper": {"ba": {"dist_ba": "off"}}}
SP_MAST3R_CONF = merge_conf({
    "image_priors": {"depth": {"prior_std_multiplier": 0.862}},
    "extractors": {"normals": "metric3dv2-normals", "features": "superpoint", "dense_matcher": "mast3r",
                   "pairs_type": "retrieval", "n_retrieval": 20,
                   "feature_conf": {"weights_path": None, "max_keypoints": 6000, "nms_radius": 4, "resize_max": 1600},
                   "dense_matcher_conf": {"weights_path": None, "mode": "sparse"}},
    "matches_mode": "sparse+depth+cache"}, TWO_VIEW_CUTS)
SP_MAST3R_DENSE_CONF = merge_conf(SP_MAST3R_CONF, {"matches_mode": "sparse+dense+depth",
                                                   "extractors": {"dense_matcher_conf": {"mode": "sparse+dense"}}})
SP_LG_DAV2_CONF = merge_conf({
    "matches_mode": "sparse",
    "extractors": {"features": "superpoint", "matcher": "lightglue", "depth": "depthanythingv2-outdoor",
                   "pairs_type": "retrieval", "n_retrieval": 20,
                   "feature_conf": {"weights_path": None, "max_keypoints": 6000, "nms_radius": 4, "resize_max": 1600},
                   "matcher_conf": {"weights_path": None}, "normals": "metric3dv2-normals"},
    "image_priors": {"depth": {"depth_uncertainty": 0.079, "prior_std_multiplier": 3.33,
                               "prior_uncertainty": False}}}, TWO_VIEW_CUTS)
# MASt3R at its official width (ViT-L encoder + base decoder) and DepthAnythingV2-vitl (metric, input 518) on the
# neural phase's render (5 images of 640×480: 30×40 patches, 1200 tokens a view), their checkpoints seeded on the
# card in the official layouts. Card against CPU cut: MASt3R at its official widths with 2 encoder and 4 decoder
# blocks on a 128×160 pair, TwoViewNet and WarpNet at their default widths on a 240×320 pair, DepthAnythingV2 at
# vitl's widths with 4 blocks at input 140 on one image. The reconstructs (d) on the render's first pipeline_images
# images (3 pairs), so that the whole script stays within its time. "small": a rehearsal on the CPU at tests' tiny
# widths.
TWO_VIEW_SIZES = {
    "full": dict(neural="full", mast3r={}, da2={}, cpu_mast3r=dict(enc_depth=2, dec_depth=4), cpu_hw=(128, 160),
                 tv_hw=(240, 320), cpu_da2=dict(depth=4, hooks=(0, 1, 2, 3), input_size=140), pipeline_images=3),
    "small": dict(neural="small",
                  mast3r=dict(enc_dim=32, enc_depth=2, enc_heads=2, dec_dim=24, dec_depth=4, dec_heads=2, patch=16,
                              desc_dim=6, rope_freq=100.0, dpt_layer_dims=(8, 12, 16, 16), dpt_feature_dim=16,
                              mlp_hidden_factor=1.0),
                  da2=dict(encoder="vits", dim=32, depth=4, heads=2, hooks=(0, 1, 2, 3), features=16,
                           out_channels=(8, 12, 16, 16), input_size=70),
                  cpu_mast3r={}, cpu_hw=(64, 96), tv_hw=(64, 96), cpu_da2={}, pipeline_images=3),
}
# card against CPU: each output within TWO_VIEW_REL of its largest magnitude (float32's summation order through the
# blocks); MASt3R's forward launches K4 MAST3R_K4 times at the official depth (24 encoder blocks over both views,
# 12 self- and 12 cross-attentions in each decoder stack)
TWO_VIEW_REL = 1e-3
MAST3R_K4 = 72


def two_view_checkpoints(d, size, dev, seed=SEED + 30):
    """MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth (the naver
    wrapper format, {"model": sd}) and depth_anything_v2_metric_vkitti_vitl.pth
    in the official layouts (seeded_state_dict, drawn on `dev`) at the size's
    widths: at full width the pinned manifests' names and shapes, at small
    those of the port's nets at the tiny configs. Returns {role: path} and
    the seconds it took."""
    import torch

    from mpsfm_tpu_torch.extraction.manifest import load_manifest
    from mpsfm_tpu_torch.extraction.nets import depth_anything, mast3r

    t = time.perf_counter()
    d.mkdir(parents=True, exist_ok=True)
    if size["neural"] == "full":
        m_shapes, d_shapes = load_manifest("mast3r"), load_manifest("depthanythingv2-vitl")
    else:
        m_shapes = {n: s for n, s, _, _ in mast3r.param_specs(mast3r.Mast3rNet(size["mast3r"], device="cpu").conf)}
        d_shapes = {n: s for n, s, _, _ in depth_anything.param_specs(
            depth_anything.DepthAnythingV2(size["da2"], device="cpu").conf)}
    paths = {"mast3r": d / mast3r.FILE, "da2": d / "depth_anything_v2_metric_vkitti_vitl.pth"}
    torch.save({"model": seeded_state_dict(m_shapes, seed, dev)}, paths["mast3r"])
    torch.save(seeded_state_dict(d_shapes, seed + 1, dev), paths["da2"])
    return paths, time.perf_counter() - t


@contextlib.contextmanager
def mast3r_attention_spy():
    """Keep the arguments of MASt3R's first encoder self-attention and first
    decoder cross-attention (calls 0 and 25 of a forward at the official
    depth: 24 encoder calls, then each decoder block's self and cross) and
    count forwards. Yields (kept, forwards)."""
    from mpsfm_tpu_torch.extraction.nets import mast3r

    import torch

    kept, calls, forwards = {}, [0], [0]
    orig_att, orig_fwd = mast3r.multi_head, mast3r.Mast3rNet.forward

    def att(q, k, v):
        which = {0: "encoder", 25: "decoder_cross"}.get(calls[0])
        if which:  # attention's arguments as multi_head passes them
            kept.setdefault(which, (q, k, v, torch.ones(k.shape[:2], dtype=torch.bool, device=q.device),
                                    q.shape[-1] ** -0.5))
        calls[0] += 1
        return orig_att(q, k, v)

    def fwd(self, *a, **k):
        forwards[0] += 1
        calls[0] = 0
        return orig_fwd(self, *a, **k)

    mast3r.multi_head, mast3r.Mast3rNet.forward = att, fwd
    try:
        yield kept, forwards
    finally:
        mast3r.multi_head, mast3r.Mast3rNet.forward = orig_att, orig_fwd


def two_view_full_width(dev, paths, size, grays, rgbs):
    """(a) MASt3R at full width on `dev`, loaded through the port's loader
    (manifest-checked at the official size), on every pair of the gray
    images as Extraction hands them: ms a pair by stage (the encoder, the
    decoders, the DPT heads, the local-feature heads, the reciprocal NN),
    matches a pair, peak memory, K4's float32 launches a forward; its first
    encoder and cross-attention arguments kept. (b) DepthAnythingV2-vitl
    (metric) on every image, its last attention's arguments kept (K4
    float32, 24 launches a forward). Returns the summary and the kept
    arguments."""
    import torch

    from mpsfm_tpu_torch.extraction.matchers import attention as att
    from mpsfm_tpu_torch.extraction.nets import depth_anything
    from mpsfm_tpu_torch.extraction.nets.depth_anything import DepthAnythingV2
    from mpsfm_tpu_torch.extraction.nets.mast3r import Mast3rMatcher

    out = {}
    m = Mast3rMatcher({**size["mast3r"], "weights_path": str(paths["mast3r"])}, device=dev)
    out["mast3r_params"] = sum(v.numel() for v in m.net.params.values())
    m(grays[0], grays[1])  # warm-up
    sync(dev)
    pairs = [(a, b) for a in range(len(grays)) for b in range(a + 1, len(grays))]
    times = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n0 = att.KERNEL.launches
    with mast3r_attention_spy() as (kept, forwards):
        t = time.perf_counter()
        res = [m(grays[a], grays[b], times=times) for a, b in pairs]
        sync(dev)
        wall = time.perf_counter() - t
    out["k4_launches"] = att.KERNEL.launches - n0
    out["forwards"] = forwards[0]
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    out["mast3r_s_per_pair"] = wall / len(pairs)
    out["mast3r_stage_s"] = {k: v / len(pairs) for k, v in times.items()}
    out["mast3r_matches"] = [len(r["certainty"]) for r in res]
    out["tokens"] = (grays[0].shape[0] // 16) * (grays[0].shape[1] // 16)
    out["mast3r_ok"] = all(np.isfinite(r["keypoints0"]).all() and np.isfinite(r["certainty"]).all() for r in res)
    del m
    net = DepthAnythingV2({**size["da2"], "depth_estimation_type": "metric", "max_depth": 80.0,
                           "weights_path": str(paths["da2"])}, device=dev)
    out["da2_params"] = sum(v.numel() for v in net.params.values())
    net.infer_image(rgbs[0])  # warm-up
    sync(dev)
    n0 = att.KERNEL.launches
    with last_call(depth_anything, "multi_head", lambda a, out: 0) as kept_da2:
        t = time.perf_counter()
        depths = [net.infer_image(im) for im in rgbs]
        sync(dev)
        out["da2_s"] = (time.perf_counter() - t) / len(rgbs)
    q, k, v = kept_da2["args"]  # as multi_head takes them: every key real, scale 1/sqrt(hd)
    kept["da2_vitl"] = (q, k, v, torch.ones(k.shape[:2], dtype=torch.bool, device=q.device), q.shape[-1] ** -0.5)
    out["da2_k4_launches"] = att.KERNEL.launches - n0
    out["da2_ok"] = all(d.shape == rgbs[0].shape[:2] and np.isfinite(d).all() and (d > 0).all() for d in depths)
    del net
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, kept


def rel_gap(a, b):
    """max |a - b| over the largest |b| (numpy or tensors)."""
    a, b = (np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64) for x in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def two_view_card_vs_cpu(dev, size, rgbs):
    """(c) The nets on `dev` and on the CPU on the same weights and inputs,
    cut: MASt3R at its official widths with few blocks (size["cpu_mast3r"])
    on a pair cut to cpu_hw (pointmaps, confidences, descriptors and their
    confidences), TwoViewNet and WarpNet at their default widths (seeded
    init, a pair at tv_hw), DepthAnythingV2 (vitl widths, few blocks) on one
    image. Each output within TWO_VIEW_REL of its largest magnitude.
    Returns the gaps and "ok"."""
    import torch

    from mpsfm_tpu_torch.extraction.nets import depth_anything, mast3r, two_view, warp
    from mpsfm_tpu_torch.extraction.nets.depth_anything import _resize

    cpu = torch.device("cpu")
    h, w = size["cpu_hw"]
    imgs = [_resize(torch.as_tensor(im, dtype=torch.float32)[None], (h, w))[0].numpy() for im in rgbs[:2]]
    mconf = {**(size["mast3r"] or mast3r.MODEL_CONFIG), **size["cpu_mast3r"]}
    shapes = {n: s for n, s, _, _ in mast3r.param_specs(mast3r.Mast3rNet(mconf, device="cpu").conf)}
    sd = seeded_state_dict(shapes, SEED + 33, dev)
    fwd = {}
    for d in (dev, cpu):
        net = mast3r.Mast3rNet(mconf, device=d)
        net.params = net.params_from_torch_state_dict(sd)
        xa, xb = two_view.padded_pair(*((two_view.prep_rgb(im) - mast3r.DUST3R_MEAN) / mast3r.DUST3R_STD
                                        for im in imgs), 16, d)
        with torch.no_grad():
            fwd[d.type] = net.forward(xa, xb, (h // 16, w // 16))
    gaps = {f"mast3r_{k}": rel_gap(fwd[dev.type][k], fwd["cpu"][k]) for k in fwd["cpu"]}
    th, tw = size["tv_hw"]
    pair = [_resize(torch.as_tensor(im, dtype=torch.float32)[None], (th, tw))[0].numpy() for im in rgbs[:2]]
    tv, wp = {}, {}
    for d in (dev, cpu):
        tv[d.type] = two_view.TwoViewMatcher(device=d)._forward(*pair)[0]
        wm = warp.WarpMatcher(device=d)
        xa, xb = two_view.padded_pair(two_view.prep_rgb(pair[0]), two_view.prep_rgb(pair[1]), 32, d)
        with torch.no_grad():
            wp[d.type] = wm.net(xa, xb)
    gaps.update({f"two_view_{k}": rel_gap(tv[dev.type][k], tv["cpu"][k]) for k in tv["cpu"]})
    gaps["warp"], gaps["warp_certainty"] = (rel_gap(a, b) for a, b in zip(wp[dev.type], wp["cpu"]))
    dconf = {**(size["da2"] or {}), **size["cpu_da2"], "depth_estimation_type": "metric", "max_depth": 80.0}
    shapes = {n: s for n, s, _, _ in depth_anything.param_specs(depth_anything.DepthAnythingV2(dconf, device="cpu").conf)}
    sd = seeded_state_dict(shapes, SEED + 34, dev)
    depth = {}
    for d in (dev, cpu):
        net = depth_anything.DepthAnythingV2(dconf, device=d)
        net.params = net.params_from_torch_state_dict(sd)
        depth[d.type] = net.infer_image(rgbs[0])
    gaps["da2_depth"] = rel_gap(depth[dev.type], depth["cpu"])
    return dict(gaps=gaps, ok=all(v <= TWO_VIEW_REL for v in gaps.values()))


@contextlib.contextmanager
def two_view_seen():
    """Record the MASt3R matchers and DepthAnythingV2 backends the pipeline
    builds, the device of each of their forwards and the forwards' count.
    Yields (models: role -> list, seen: role -> set of device types,
    forwards: role -> count)."""
    from mpsfm_tpu_torch.extraction import priors
    from mpsfm_tpu_torch.extraction.nets import depth_anything, mast3r

    roles = ("mast3r", "da2")
    models, seen, forwards = ({r: [] for r in roles}, {r: set() for r in roles}, {r: 0 for r in roles})
    orig = dict(matcher=mast3r.Mast3rMatcher, be=priors._DA2Backend, mfwd=mast3r.Mast3rNet.forward,
                dfwd=depth_anything.DepthAnythingV2.forward)

    def recorder(cls, role):
        def make(*a, **k):
            m = cls(*a, **k)
            models[role].append(m)
            return m

        return make

    def spy(fn, role):
        def fwd(self, x, *a, **k):
            seen[role].add(x.device.type)
            forwards[role] += 1
            return fn(self, x, *a, **k)

        return fwd

    mast3r.Mast3rMatcher, priors._DA2Backend = recorder(orig["matcher"], "mast3r"), recorder(orig["be"], "da2")
    mast3r.Mast3rNet.forward = spy(orig["mfwd"], "mast3r")
    depth_anything.DepthAnythingV2.forward = spy(orig["dfwd"], "da2")
    try:
        yield models, seen, forwards
    finally:
        mast3r.Mast3rMatcher, priors._DA2Backend = orig["matcher"], orig["be"]
        mast3r.Mast3rNet.forward, depth_anything.DepthAnythingV2.forward = orig["mfwd"], orig["dfwd"]


def two_view_conf(base, npaths, tpaths, size):
    """A phase 16 conf with the checkpoints' paths: the neural phase's mapping
    pair of SuperPoint and LightGlue, the Metric3Dv2-small normals, MASt3R
    where the conf takes the mast3r dense matcher, DepthAnythingV2 where it
    takes its depth."""
    nsize = NEURAL_SIZES[size["neural"]]
    conf = json.loads(json.dumps(base))
    ex = conf["extractors"]
    ex["feature_conf"].update(weights_path=str(npaths["features_mapping"]), **nsize["sp"])
    if ex.get("matcher") == "lightglue":
        ex["matcher_conf"].update(weights_path=str(npaths["matcher_mapping"]), **nsize["lg"])
    ex["normals_conf"].update(weights_path=str(npaths["depth"]), **nsize["m3d_tiny"])
    if ex.get("dense_matcher") == "mast3r":
        ex["dense_matcher_conf"].update(weights_path=str(tpaths["mast3r"]), **size["mast3r"])
    if ex.get("depth", "").startswith("depthanythingv2"):
        ex["depth_conf"] = {"weights_path": str(tpaths["da2"]), **size["da2"]}
    return conf


def k4_per_forward(models):
    """K4 launches a forward of each role's net: MASt3R enc_depth + 4 dec_depth
    (each decoder block of both stacks a self- and a cross-attention),
    DepthAnythingV2 one a block."""
    out = {}
    for m in models["mast3r"]:
        out["mast3r"] = m.net.conf["enc_depth"] + 4 * m.net.conf["dec_depth"]
    for b in models["da2"]:
        out["da2"] = b.net.conf["depth"]
    return out


def two_view_pipeline(dev, counted, what, conf, data_dir, n_images):
    """(d) The port's reconstruct under `conf` over a copy of the render's
    first n_images images without their sensor depth, the launch counts at
    0 just before. Held: it
    reaches its outputs (the text model written and read back); the
    MASt3R or DepthAnythingV2 nets it builds hold their tensors on `dev` and
    run their forwards there; under the mast3r confs the pair-depth store
    holds both images of every pair (MASt3R's pair depth: no image has
    sensor depth) and, where the conf matches densely, the dense store every
    pair; under sp-lg_dav2 DepthAnythingV2's depth store every image; on
    the card K4's float32 kernel launched k4_per_forward times a forward of
    those nets (MAST3R_K4 a MASt3R forward) and nowhere else, and the
    tensor-core kernel 36 times a (bfloat16) LightGlue forward. Not held
    (seeded weights): registered images, points. Returns (summary,
    launches)."""
    import shutil
    from pathlib import Path

    from mpsfm_tpu_torch.utils import io
    from mpsfm_tpu_torch.utils.profiling import TIMERS

    data = Path(data_dir).parent / what.replace("/", "_")
    shutil.copytree(data_dir, data)
    shutil.rmtree(data / "depth")  # no sensor depth: MASt3R's pair depth or DepthAnythingV2's is the depth prior
    for img in sorted((data / "images").iterdir())[n_images:]:
        img.unlink()
    TIMERS.reset()
    for k in counted.values():
        k.launches = 0
    with two_view_seen() as (models, seen, forwards), attention_spy() as (_, lg_fwd):
        rec, ok, wall = run_pipeline(data, conf, dev)
    launches = {name: k.launches for name, k in counted.items()}
    pipe = {k: round(v, 4) for k, v in TIMERS.totals.items() if k.startswith("pipe.")}
    check_written_model(rec, data / "sfm_outputs")
    cache = data / "cache"
    names = sorted(p.name for p in (data / "images").iterdir())
    pairs = io.read_pairs(cache / "pairs.txt")
    ex = conf["extractors"]
    tensors = {role: sorted({t.device.type for m in ms for t in m.net.params.values()}) for role, ms in models.items()}
    out = dict(ok=bool(ok), registered=rec.num_reg_images(), images=rec.num_images(), points=rec.num_points3D(),
               wall=wall, pipe=pipe, pairs=len(pairs), forwards=dict(forwards, lightglue=lg_fwd[0]),
               tensors=tensors, seen={k: sorted(v) for k, v in seen.items()})
    problems = []
    want = {"mast3r": ex.get("dense_matcher") == "mast3r", "da2": ex.get("depth", "").startswith("depthanythingv2")}
    for role, used in want.items():
        if used and (tensors[role] != [dev.type] or out["seen"][role] != [dev.type] or not forwards[role]):
            problems.append(f"{role} off {dev.type}: tensors {tensors[role]}, forwards {out['seen'][role]}")
    if want["mast3r"]:
        pd = cache / "pair-depth-mast3r.npyd"
        maps = {(a, b): [io.get_mono_map_from_pairs(pd, n, [(a, b)]) for n in (a, b)] for a, b in pairs}
        out["pair_depths"] = sum(all(m is not None for m in ms) for ms in maps.values())
        out["valid_share"] = float(np.mean([m["valid"].mean() for ms in maps.values() for m in ms if m is not None]))
        if out["pair_depths"] != len(pairs):
            problems.append(f"pair depths for {out['pair_depths']} of {len(pairs)} pairs")
        if "dense" in conf["matches_mode"]:
            out["dense_per_pair"] = [len(io.get_dense_pair(cache / "dense-mast3r.npyd", a, b)[2]) for a, b in pairs]
            if not any(out["dense_per_pair"]):
                problems.append(f"dense pairs {out['dense_per_pair']}")
    if want["da2"]:
        keys = [set(io.get_mono_map(cache / "depth-depthanythingv2-outdoor.npyd", n) or ()) for n in names]
        out["depth_keys"] = sorted(keys[0])
        if not all({"depth", "depth_variance", "normals"} <= k for k in keys):
            problems.append(f"depth store keys {[sorted(k) for k in keys]}")
    per = k4_per_forward(models)
    out["k4_per_forward"] = per
    if dev.type == "cuda":
        want_f32 = sum(per[r] * forwards[r] for r in per)
        want_tc = 36 * lg_fwd[0]
        if launches.get("attention") != want_f32 or launches.get("attention_tc") != want_tc or (
                want["mast3r"] and per["mast3r"] != MAST3R_K4):
            problems.append(f"K4 launches {launches.get('attention')} float32 (want {want_f32}: {per} a forward) and "
                            f"{launches.get('attention_tc')} on the tensor cores (want {want_tc})")
    print(f"two-view pipeline ({what}, {len(names)} images without sensor depth): {wall:.3f} s wall, reached its "
          f"outputs; registered {out['registered']}/{out['images']}, {out['points']} points (not held: seeded "
          f"weights); {len(pairs)} pairs; forwards {json.dumps(out['forwards'])}, K4 a forward {json.dumps(per)}; "
          + (f"pair depths for {out['pair_depths']} pairs, valid share {out['valid_share']:.3f}; "
             if want["mast3r"] else "")
          + (f"dense matches a pair {out['dense_per_pair']}; " if "dense_per_pair" in out else "")
          + (f"depth store keys {out['depth_keys']}; " if want["da2"] else "")
          + f"tensors on {json.dumps(tensors)}, forwards on {json.dumps(out['seen'])}; launches {json.dumps(launches)}")
    print(f"two-view pipeline ({what}) pipe.* phases (s wall): {json.dumps(pipe)}")
    if problems:
        raise AssertionError(f"two-view pipeline ({what}): {problems}: {out}")
    return out, launches


def two_view_phase(dev, counted, size="full"):
    """Slice 15, the two-view nets: seeded checkpoints in the official layouts
    (two_view_checkpoints; the neural phase's SuperPoint, LightGlue and
    Metric3Dv2-small ones by neural_checkpoints), loaded through the port's
    loaders; (a) MASt3R at full width on every pair of the render and (b)
    DepthAnythingV2-vitl on every image (two_view_full_width); K4 against
    attention_plain at MASt3R's encoder and cross-attention shapes and at
    DepthAnythingV2's (k4_check: K4's time beside SDPA's and the bound); (c) MASt3R,
    TwoViewNet, WarpNet and DepthAnythingV2 card against CPU, cut
    (two_view_card_vs_cpu); (d) the port's reconstruct under
    SP_MAST3R_CONF, SP_MAST3R_DENSE_CONF and SP_LG_DAV2_CONF on the render's
    first pipeline_images images without sensor depth (two_view_pipeline). size: "full", or "small" for a
    rehearsal on the CPU (counted {}; no K4 check). Returns (summary,
    {run: launches}, {shape: K4 row})."""
    import tempfile
    from pathlib import Path

    import torch

    dev = torch.device(dev)
    size_name, size = size, TWO_VIEW_SIZES[size]
    nsize = NEURAL_SIZES[size["neural"]]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        npaths, n_s = neural_checkpoints(Path(tmp) / "weights", nsize)
        tpaths, t_s = two_view_checkpoints(Path(tmp) / "weights", size, dev)
        data = Path(tmp) / "scene"
        render_rgbd_dir(data, **nsize["render"])
        cfg = nsize["render"]
        grays, rgbs = neural_images(data)
        full, kept = two_view_full_width(dev, tpaths, size, grays, rgbs)
        st = full["mast3r_stage_s"]
        per_fwd = full["k4_launches"] / max(full["forwards"], 1)
        print(f"two-view nets ({size_name}): checkpoints written in {n_s + t_s:.2f} s; MASt3R "
              f"({full['mast3r_params'] / 1e6:.2f} M params) at {cfg['img_wh'][0]}x{cfg['img_wh'][1]} ({full['tokens']} "
              f"tokens a view) {full['mast3r_s_per_pair'] * 1e3:.2f} ms a pair: "
              + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in st.items())
              + f"; matches a pair {full['mast3r_matches']}; peak memory "
              + (f"{full['peak_gb']:.2f} GB" if full["peak_gb"] is not None else "not measured (CPU)")
              + f"; K4 float32 launches {full['k4_launches']} for {full['forwards']} forwards ({per_fwd:g} a forward); "
              f"DepthAnythingV2-vitl ({full['da2_params'] / 1e6:.2f} M params, metric, input "
              f"{size['da2'].get('input_size', 518)}) {full['da2_s'] * 1e3:.2f} ms an image, K4 launches "
              f"{full['da2_k4_launches']} for {len(rgbs)} images")
        if not (full["mast3r_ok"] and full["da2_ok"]) or (dev.type == "cuda" and per_fwd != MAST3R_K4):
            raise AssertionError(f"two-view nets full width: {full}")
        k4 = {}
        if dev.type == "cuda":
            for name, args in kept.items():
                B, N, H, hd = args[0].shape
                net = "DepthAnythingV2-vitl's" if name == "da2_vitl" else f"MASt3R's {name}"
                k4[name] = k4_check(f"K4 at {net} attention ({B}x{N}x{H}x{hd} against {args[1].shape[1]} keys, all "
                                    "real), float32", args)
        del kept
        t = time.perf_counter()
        vs = two_view_card_vs_cpu(dev, size, rgbs)
        print(f"two-view nets card vs CPU ({time.perf_counter() - t:.1f} s; each output's largest gap over its largest "
              f"magnitude, bound {TWO_VIEW_REL}): " + ", ".join(f"{k} {v:.2e}" for k, v in vs["gaps"].items()))
        if not vs["ok"]:
            raise AssertionError(f"two-view nets card vs CPU: {vs}")
        runs, launches = {}, {}
        for what, base in (("sp-mast3r", SP_MAST3R_CONF), ("sp-mast3r-dense", SP_MAST3R_DENSE_CONF),
                           ("sp-lg_dav2", SP_LG_DAV2_CONF)):
            runs[what], launches[what] = two_view_pipeline(dev, counted, what, two_view_conf(base, npaths, tpaths, size),
                                                           data, size["pipeline_images"])
    print(f"two-view nets phase: {time.perf_counter() - t0:.1f} s wall")
    return dict(full=full, card_vs_cpu=vs, pipelines=runs), launches, k4


# ---- the prior nets (slice 17): DepthPro, the vit_mono prior and its on-scene trainer ----

# configs/sp-lg_depthpro.yaml as the port loads it, with phase 16's cuts (TWO_VIEW_CUTS: the Metric3Dv2
# normals cut to small, the directory store, dist_ba off)
SP_LG_DEPTHPRO_CONF = merge_conf({
    "matches_mode": "sparse",
    "extractors": {"features": "superpoint", "matcher": "lightglue", "depth": "depthpro",
                   "pairs_type": "retrieval", "n_retrieval": 20,
                   "feature_conf": {"weights_path": None, "max_keypoints": 6000, "nms_radius": 4, "resize_max": 1600},
                   "matcher_conf": {"weights_path": None}, "normals": "metric3dv2-normals"},
    "image_priors": {"depth": {"depth_uncertainty": 0.0875, "prior_std_multiplier": 3.33,
                               "prior_uncertainty": False}}}, TWO_VIEW_CUTS)
# tests/test_trained_prior_e2e.py's prior conf (classical features, the mutual NN, exhaustive pairs, the prior's
# own variances) with the directory store and dist_ba off; the phase adds the trained backend's conf
VIT_MONO_CONF = {"matches_mode": "sparse", "cache_format": "npy",
                 "extractors": {"features": "classical", "matcher": "nn", "pairs_type": "exhaustive",
                                "depth": "vit_mono", "feature_conf": {"max_keypoints": 1024}, "resize_max": 0},
                 "mapper": {"int_covs": False, "ba": {"max_iters": 10, "dist_ba": "off"},
                            "registration": {"num_hyp": 256}},
                 "image_priors": {"depth": {"prior_uncertainty": True, "depth_uncertainty": 0.05,
                                            "prior_std_multiplier": 2.0}}}
# DepthPro at its official width (three ViT-L/14 at 384, 951.9 M parameters, seeded on the card in the HF
# layout) on the neural phase's render (640×480); card against CPU cut: its widths with 2 blocks a ViT at a
# 448² input (a 112² ViT: the same 1 + 9 + 25 patch pyramid at a quarter of the side). The reconstructs (b)
# and (c) on the render's first pipeline_images images without their sensor depth. The trainer (c) at
# fit_scene_prior's default net (96 wide, 2 heads of 48) on the whole render with depth at resize_long 160
# (160 × 120, padded to 160 × 128: 80 tokens), train_steps steps of 8 frames, lr 2e-3 (the e2e test's). "small":
# a rehearsal on the CPU at tests' tiny widths.
PRIOR_SIZES = {
    "full": dict(neural="full", depthpro={},
                 cpu_depthpro=dict(depth=2, intermediate_hook_ids=(1, 0), vit_image_size=112, patch_size=112,
                                   image_size=448),
                 pipeline_images=3, min_registered=3, net={}, train_steps=120, batch=8, resize_long=160),
    "small": dict(neural="small",
                  depthpro=dict(dim=32, depth=3, heads=2, vit_image_size=56, vit_patch=14, patch_size=56,
                                image_size=224, scaled_images_feature_dims=(16, 16, 8), intermediate_hook_ids=(2, 1),
                                intermediate_feature_dims=(8, 8), fusion_hidden_size=8),
                  cpu_depthpro={}, pipeline_images=3, min_registered=2,
                  net=dict(dim=32, depth_blocks=2, num_heads=2, feat=16),
                  train_steps=6, batch=2, resize_long=64),
}
# DepthPro's card against CPU: each output within PRIOR_REL of its largest magnitude (float32's summation order
# through two ViT blocks and the decoder); a forward launches K4 DEPTHPRO_K4 times at the official depth (24
# blocks in each of the patch, image and FOV encoders). The trainer's one step on the card: every parameter's
# gradient within TRAIN_GRAD_REL of the CPU's in norm, ‖g_card − g_cpu‖ / ‖g_cpu‖ (float32's summation order,
# cuDNN's among it; on an H100 the largest element's gap reached 5.0e-4 of its parameter's largest, at the
# position embedding's gradient, a sum over every token); the key bias, whose gradient is 0 but for rounding,
# against the whole qkv bias's norm
PRIOR_REL, DEPTHPRO_K4, TRAIN_GRAD_REL = 1e-4, 72, 1e-3


def depth_pro_checkpoint(path, conf, dev, seed):
    """DepthPro's state dict in the HF layout (mask tokens included) at conf's
    widths, drawn on `dev` by nets/depth_pro.draw, saved to path. Its depths
    are noise, as the earlier phases' seeded nets' are: with the last layer
    set to a constant depth instead (at the render's median 3.56, at 5 or at
    40), (b) registered 0 of 3 images on an H100, where the seeded draw
    registers 3. Returns the seconds it took."""
    import torch

    from mpsfm_tpu_torch.extraction.nets import depth_pro

    t = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    sd = {name: depth_pro.draw(name, shape, g, dev).cpu() for name, shape in depth_pro.param_specs(conf)}
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path)
    return time.perf_counter() - t


def depth_pro_full_width(dev, path, size, rgbs, f_px):
    """(a) DepthPro at full width on `dev`, loaded through the port's loader
    (manifest-checked at the official size), on every image: ms an image by
    stage (patch encoder, image encoder, decoder, FOV head), K4 launches a
    forward, peak memory; the arguments of its largest attention (the patch
    encoder's) kept. Returns the summary and K4's arguments."""
    import torch

    from mpsfm_tpu_torch.extraction.matchers import attention as att
    from mpsfm_tpu_torch.extraction.nets import depth_pro

    net = depth_pro.DepthPro({**size["depthpro"], "weights_path": str(path)}, device=dev)
    out = {"params": sum(v.numel() for v in net.params.values())}
    net.infer_image(rgbs[0], f_px=f_px)  # warm-up
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = {}
    n0 = att.KERNEL.launches
    with last_call(depth_pro, "multi_head", lambda a, res: a[0].shape[0]) as kept:
        t = time.perf_counter()
        res = [net.infer_image(im, f_px=f_px, times=times) for im in rgbs]
        sync(dev)
        out["s_per_image"] = (time.perf_counter() - t) / len(rgbs)
    out["k4_launches"] = att.KERNEL.launches - n0
    out["forwards"] = len(rgbs)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    out["stage_s"] = {k: v / len(rgbs) for k, v in times.items()}
    out["ok"] = all(r["depth"].shape == rgbs[0].shape[:2] and np.isfinite(r["depth"]).all() and (r["depth"] > 0).all()
                    for r in res)
    out["depth_median"] = float(np.median(res[0]["depth"]))
    q, k, v = kept["args"]
    del net, res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, (q, k, v, torch.ones(k.shape[:2], dtype=torch.bool, device=q.device), q.shape[-1] ** -0.5)


def depth_pro_card_vs_cpu(dev, size, rgb):
    """DepthPro on `dev` and on the CPU on the same seeded weights and input,
    cut (size["cpu_depthpro"] over the size's widths): inverse depth and FOV
    each within PRIOR_REL of its largest magnitude. Returns the gaps."""
    import torch

    from mpsfm_tpu_torch.extraction.nets.depth_anything import IMAGENET_MEAN, IMAGENET_STD, _resize
    from mpsfm_tpu_torch.extraction.nets.depth_pro import DepthPro

    conf = {**size["depthpro"], **size["cpu_depthpro"]}
    cpu = DepthPro(conf, device="cpu")
    cpu.init_random(SEED + 40)
    card = DepthPro(conf, device=dev)
    card.params = {k: v.to(dev) for k, v in cpu.params.items()}
    S = cpu.conf["image_size"]
    x = _resize(torch.as_tensor((rgb.astype(np.float32) / 255 - IMAGENET_MEAN) / IMAGENET_STD)[None], (S, S))
    with torch.no_grad():
        inv_c, fov_c = cpu.forward(x)
        inv_d, fov_d = card.forward(x.to(dev))
    return {"inverse_depth": rel_gap(inv_d, inv_c), "fov": rel_gap(fov_d, fov_c)}


@contextlib.contextmanager
def prior_seen():
    """Record the DepthPro and MonoViT nets the pipeline builds (through
    their backends), the device of each of their forwards and the forwards'
    count. Yields (models: role -> list of nets, seen: role -> set of
    device types, forwards: role -> count)."""
    from mpsfm_tpu_torch.extraction import priors
    from mpsfm_tpu_torch.extraction.nets import depth_pro, mono

    roles = ("depthpro", "vit_mono")
    models, seen, forwards = ({r: [] for r in roles}, {r: set() for r in roles}, {r: 0 for r in roles})
    orig = dict(dp=priors._DepthProBackend, vm=priors._vit_mono, dfwd=depth_pro.DepthPro.forward,
                mfwd=mono.MonoViT.forward)

    def make_dp(*a, **k):
        b = orig["dp"](*a, **k)
        models["depthpro"].append(b.net)
        return b

    def make_vm(*a, **k):
        b = orig["vm"](*a, **k)
        models["vit_mono"].append(b.net)
        return b

    def spy(fn, role):
        def fwd(self, x, *a, **k):
            seen[role].add(x.device.type)
            forwards[role] += 1
            return fn(self, x, *a, **k)

        return fwd

    priors._DepthProBackend, priors._vit_mono = make_dp, make_vm
    depth_pro.DepthPro.forward, mono.MonoViT.forward = spy(orig["dfwd"], "depthpro"), spy(orig["mfwd"], "vit_mono")
    try:
        yield models, seen, forwards
    finally:
        priors._DepthProBackend, priors._vit_mono = orig["dp"], orig["vm"]
        depth_pro.DepthPro.forward, mono.MonoViT.forward = orig["dfwd"], orig["mfwd"]


def net_tensors(role, net):
    """The devices of a recorded net's parameters."""
    return {t.device.type for t in (net.params.values() if role == "depthpro" else net.parameters())}


def prior_pipeline(dev, counted, what, conf, data_dir, n_images, min_registered, check_kernels=False):
    """(b), (c) The port's reconstruct under `conf` over a copy of the render's
    first n_images images without their sensor depth, the launch counts at 0
    just before. Held: min_registered images registered (every one at full
    size; the small rehearsal's tiny nets keep few matches); the text model written and
    read back; the prior net the conf takes holds its tensors on `dev`, runs
    its forwards there and writes every image's depth store; on the card
    K4's float32 kernel launched DEPTHPRO_K4 times a DepthPro forward or
    depth_blocks times a MonoViT forward and nowhere else, and the
    tensor-core kernel 36 times a (bfloat16) LightGlue forward; with
    check_kernels, every kernel of the run held to its plain version at the
    run's shapes (check_path_kernels). Returns (summary, launches)."""
    import shutil
    from pathlib import Path

    from mpsfm_tpu_torch.utils import io
    from mpsfm_tpu_torch.utils.profiling import TIMERS

    data = Path(data_dir).parent / what
    shutil.copytree(data_dir, data)
    shutil.rmtree(data / "depth")  # no sensor depth: the prior net's depth is the depth prior
    for img in sorted((data / "images").iterdir())[n_images:]:
        img.unlink()
    TIMERS.reset()
    for k in counted.values():
        k.launches = 0
    with path_kernel_args() as kept, prior_seen() as (models, seen, forwards), attention_spy() as (_, lg_fwd):
        rec, ok, wall = run_pipeline(data, conf, dev)
    launches = {name: k.launches for name, k in counted.items()}
    pipe = {k: round(v, 4) for k, v in TIMERS.totals.items() if k.startswith("pipe.")}
    check_written_model(rec, data / "sfm_outputs")
    role = "depthpro" if conf["extractors"]["depth"] == "depthpro" else "vit_mono"
    names = sorted(p.name for p in (data / "images").iterdir())
    store = data / "cache" / f"depth-{conf['extractors']['depth']}.npyd"
    keys = [set(io.get_mono_map(store, n) or ()) for n in names]
    tensors = sorted(set().union(*(net_tensors(role, m) for m in models[role])))
    out = dict(ok=bool(ok), registered=rec.num_reg_images(), images=rec.num_images(), points=rec.num_points3D(),
               wall=wall, pipe=pipe, forwards=dict(forwards, lightglue=lg_fwd[0]), tensors=tensors,
               seen=sorted(seen[role]), depth_keys=sorted(keys[0]))
    problems = []
    if out["registered"] < min_registered:
        problems.append(f"registered {out['registered']} of {n_images}, fewer than {min_registered}")
    if tensors != [dev.type] or out["seen"] != [dev.type] or forwards[role] != n_images:
        problems.append(f"{role} off {dev.type}: tensors {tensors}, forwards {out['seen']} ({forwards[role]})")
    if not all({"depth", "depth_variance", "normals"} <= k for k in keys):
        problems.append(f"depth store keys {[sorted(k) for k in keys]}")
    per = DEPTHPRO_K4 if role == "depthpro" else models[role][0].depth_blocks
    out["k4_per_forward"] = per
    if dev.type == "cuda":
        want_f32, want_tc = per * forwards[role], 36 * lg_fwd[0]
        if launches.get("attention") != want_f32 or launches.get("attention_tc", 0) != want_tc:
            problems.append(f"K4 launches {launches.get('attention')} float32 (want {want_f32}: {per} a forward) and "
                            f"{launches.get('attention_tc')} on the tensor cores (want {want_tc})")
    print(f"prior nets pipeline ({what}, {len(names)} images without sensor depth): {wall:.3f} s wall; registered "
          f"{out['registered']}/{out['images']}, {out['points']} points; forwards {json.dumps(out['forwards'])}, K4 "
          f"{per} a {role} forward; depth store keys {out['depth_keys']}; tensors on {tensors}, forwards on "
          f"{out['seen']}; launches {json.dumps(launches)}")
    print(f"prior nets pipeline ({what}) pipe.* phases (s wall): {json.dumps(pipe)}")
    if problems:
        raise AssertionError(f"prior nets pipeline ({what}): {problems}: {out}")
    if check_kernels:
        kept_ok = {k: v["args"] is not None for k, v in kept.items()}
        if not all(kept_ok.values()):
            raise AssertionError(f"prior nets pipeline ({what}): kernels not on its path: {kept_ok}")
        if dev.type == "cuda":
            out["kernel_ms"] = check_path_kernels(f"{what} run", kept, rec, dev)
    return out, launches


def trainer_gradients(dev, size, batch, seed=SEED + 41):
    """One training step's gradients (train_mono._loss_fn on `batch`, a dict of
    host arrays) of the same seeded MonoViT on `dev` and on the CPU: each
    parameter's gap in norm over its CPU gradient's norm (the key bias's
    over the whole qkv bias's), whether every block's qkv weight got a
    non-zero gradient on `dev`, and K4's launches in the card's step (the
    forward's, one a block; its backward is torch ops). Returns a dict."""
    import torch

    from mpsfm_tpu_torch.extraction.matchers import attention as att
    from mpsfm_tpu_torch.extraction.nets.mono import MonoViT
    from mpsfm_tpu_torch.extraction.nets.train_mono import DEFAULT_NET, _loss_fn
    from mpsfm_tpu_torch.extraction.nets.vit import init_seeded

    conf = {**DEFAULT_NET, **size["net"]}
    grads, launches, losses = {}, {}, {}
    for d in (dev, torch.device("cpu")):
        net = init_seeded(MonoViT(**conf), seed).to(d).train()
        n0 = att.KERNEL.launches
        loss, _ = _loss_fn(net, {k: torch.as_tensor(v, device=d) for k, v in batch.items()})
        loss.backward()
        sync(dev)
        launches[d.type] = att.KERNEL.launches - n0
        losses[d.type] = loss.item()
        grads[d.type] = {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
    D = conf["dim"]
    gaps = {}
    for k, g in grads["cpu"].items():
        t = grads[dev.type][k]
        if k.endswith("attn.qkv.bias"):  # the key bias: rounding only, against the whole bias's scale
            gaps[k + " (keys)"] = float((t[D:2 * D] - g[D:2 * D]).norm() / g.norm())
            t, g = torch.cat([t[:D], t[2 * D:]]), torch.cat([g[:D], g[2 * D:]])
        gaps[k] = float((t - g).norm() / max(float(g.norm()), 1e-30))
    qkv = [float(grads[dev.type][f"trunk.blocks_{i}.attn.qkv.weight"].abs().max()) for i in range(conf["depth_blocks"])]
    return dict(gaps=gaps, worst=max(gaps, key=gaps.get), qkv_max=qkv, launches=launches[dev.type],
                loss=losses, ok=max(gaps.values()) <= TRAIN_GRAD_REL and min(qkv) > 0)


def prior_trainer(dev, counted, size, data, out_dir, focal):
    """(c) fit_scene_prior on `dev` over the render (every image, with its
    sensor depth), the launch counts at 0 just before: wall, steps/s, the
    loss as logged every steps / 6 steps (held: the last below the first),
    K4's launches (depth_blocks a step on the card); the arguments of one of
    its attentions kept (hd 48 at the default net). Then one step's
    gradients card against CPU (trainer_gradients) on a batch of the same
    frames. Returns (summary, the weights' backend conf, K4's arguments)."""
    import contextlib as ctx
    import io as sio

    import torch

    from mpsfm_tpu_torch.extraction.matchers import attention as att
    from mpsfm_tpu_torch.extraction.nets import train_mono, vit

    steps = size["train_steps"]
    for k in counted.values():
        k.launches = 0
    log = sio.StringIO()
    with last_call(vit, "multi_head", lambda a, res: a[0].numel()) as kept, ctx.redirect_stdout(log):
        t = time.perf_counter()
        _, bconf, hist = train_mono.fit_scene_prior(
            data, out_dir / "mono.pth", net_conf=size["net"], steps=steps, batch=size["batch"], lr=2e-3, seed=SEED,
            canonical_focal=focal, resize_long=size["resize_long"], log_every=max(steps // 6, 1), device=dev)
        sync(dev)
        wall = time.perf_counter() - t
    launches = {name: k.launches for name, k in counted.items()}
    losses = [float(m.group(1)) for m in re.finditer(r"loss ([0-9.]+)", log.getvalue())]
    out = dict(wall=wall, steps=steps, steps_per_s=steps / wall, losses=losses, history=hist,
               k4_launches=launches.get("attention"), launches=launches)
    # a batch of the trained frames as train_mono assembles them (canonical-focal depth, padded to the patch)
    images, depths, normals, valids, focals = train_mono.load_scene(data, size["resize_long"])
    depths = depths * np.float32(focal) / focals.reshape(-1, 1, 1).astype(np.float32)
    arrays = [np.stack([train_mono._pad_to_patch(a, bconf["patch"]) for a in arr]).astype(np.float32)
              for arr in (images, depths, normals, valids)]
    batch = train_mono._make_crop_batch(np.random.default_rng(SEED), *arrays, arrays[1].shape[1:3], size["batch"],
                                        bconf["patch"], False)
    out["gradients"] = trainer_gradients(dev, size, batch)
    problems = []
    if not (len(losses) >= 2 and losses[-1] < losses[0] and all(np.isfinite(losses))):
        problems.append(f"loss {losses}")
    depth_blocks = bconf["depth_blocks"]
    if dev.type == "cuda" and (out["k4_launches"] != steps * depth_blocks
                               or out["gradients"]["launches"] != depth_blocks):
        problems.append(f"K4 launches {out['k4_launches']} in {steps} steps (want {steps * depth_blocks}), "
                        f"{out['gradients']['launches']} in the gradient check's step (want {depth_blocks})")
    if not out["gradients"]["ok"]:
        problems.append(f"gradients card vs CPU: {out['gradients']}")
    g = out["gradients"]
    print(f"prior nets trainer: fit_scene_prior, {steps} steps of {size['batch']} frames at resize_long "
          f"{size['resize_long']}, net {json.dumps({k: bconf[k] for k in ('dim', 'depth_blocks', 'num_heads')})} "
          f"(heads {bconf['dim'] // bconf['num_heads']} wide): {wall:.3f} s wall, {out['steps_per_s']:.1f} steps/s; "
          f"loss every {max(steps // 6, 1)} steps {losses}; final {json.dumps({k: round(v, 4) for k, v in hist.items()})}; "
          f"K4 launches {out['k4_launches']}; one step card vs CPU: losses {g['loss']}, largest gradient gap "
          f"{g['gaps'][g['worst']]:.2e} at {g['worst']} (bound {TRAIN_GRAD_REL}), qkv weight gradients' largest "
          f"{[f'{x:.3e}' for x in g['qkv_max']]}, K4 launches in the step {g['launches']}")
    if problems:
        raise AssertionError(f"prior nets trainer: {problems}")
    q, k, v = (x.detach() for x in kept["args"])
    return out, bconf, (q, k, v, torch.ones(k.shape[:2], dtype=torch.bool, device=q.device), q.shape[-1] ** -0.5)


def prior_nets_phase(dev, counted, size="full"):
    """Slice 17, the prior nets: (a) DepthPro at full width, its checkpoint
    seeded on the card in the HF layout and loaded through the port's
    loader, on the render's first pipeline_images images of 640×480
    (depth_pro_full_width), K4 against attention_plain at its patch
    encoder's shape (k4_check: K4 beside SDPA and the bound), card against
    CPU cut (depth_pro_card_vs_cpu); (b) the port's reconstruct under
    SP_LG_DEPTHPRO_CONF on those images without sensor depth
    (prior_pipeline: 3/3 registered, its kernels held by
    check_path_kernels); (c) the trainer on the card (prior_trainer), K4's
    hd 48 route at the trainer's shape, and the reconstruct with the
    trained vit_mono prior (VIT_MONO_CONF) on those images. The neural
    phase's SuperPoint, LightGlue and Metric3Dv2-small checkpoints come from
    neural_checkpoints. size: "full", or "small" for a rehearsal on the CPU
    (counted {}; no K4 check). Returns (summary, {run: launches}, {"depthpro":
    K4 row, "hd48": K4 row})."""
    import tempfile
    from pathlib import Path

    import torch

    from mpsfm_tpu_torch.extraction.nets.depth_pro import MODEL_CONFIG

    dev = torch.device(dev)
    size_name, size = size, PRIOR_SIZES[size]
    nsize = NEURAL_SIZES[size["neural"]]
    cfg = nsize["render"]
    f_px = cfg["focal"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        npaths, n_s = neural_checkpoints(tmp / "weights", nsize)
        dp_path = tmp / "weights" / "depth_pro.pt"
        dp_s = depth_pro_checkpoint(dp_path, {**MODEL_CONFIG, **size["depthpro"]}, dev, SEED + 42)
        data = tmp / "scene"
        render_rgbd_dir(data, **cfg)
        _, rgbs = neural_images(data)
        n = size["pipeline_images"]
        full, k4_args = depth_pro_full_width(dev, dp_path, size, rgbs[:n], f_px)
        st = full["stage_s"]
        per_fwd = full["k4_launches"] / full["forwards"]
        print(f"prior nets ({size_name}): checkpoints written in {n_s + dp_s:.2f} s; DepthPro "
              f"({full['params'] / 1e6:.2f} M params) at {cfg['img_wh'][0]}x{cfg['img_wh'][1]} {full['s_per_image'] * 1e3:.2f} "
              f"ms an image: " + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in st.items())
              + "; peak memory " + (f"{full['peak_gb']:.2f} GB" if full["peak_gb"] is not None else "not measured (CPU)")
              + f"; K4 float32 launches {full['k4_launches']} for {full['forwards']} forwards ({per_fwd:g} a forward); "
              f"median depth {full['depth_median']:.4g}")
        if not full["ok"] or (dev.type == "cuda" and per_fwd != DEPTHPRO_K4):
            raise AssertionError(f"prior nets DepthPro full width: {full}")
        k4 = {}
        if dev.type == "cuda":
            B, N, H, hd = k4_args[0].shape
            k4["depthpro"] = k4_check(f"K4 at DepthPro's patch encoder attention ({B}x{N}x{H}x{hd} against "
                                      f"{k4_args[1].shape[1]} keys, all real), float32", k4_args)
        del k4_args
        t = time.perf_counter()
        gaps = depth_pro_card_vs_cpu(dev, size, rgbs[0])
        print(f"prior nets DepthPro card vs CPU ({time.perf_counter() - t:.1f} s, cut: "
              f"{json.dumps(size['cpu_depthpro'])}; each output's largest gap over its largest magnitude, bound "
              f"{PRIOR_REL}): " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
        if max(gaps.values()) > PRIOR_REL:
            raise AssertionError(f"prior nets DepthPro card vs CPU: {gaps}")
        runs, launches = {}, {}
        conf = json.loads(json.dumps(SP_LG_DEPTHPRO_CONF))
        ex = conf["extractors"]
        ex["feature_conf"].update(weights_path=str(npaths["features_mapping"]), **nsize["sp"])
        ex["matcher_conf"].update(weights_path=str(npaths["matcher_mapping"]), **nsize["lg"])
        ex["normals_conf"].update(weights_path=str(npaths["depth"]), **nsize["m3d_tiny"])
        ex["depth_conf"] = {"weights_path": str(dp_path), **size["depthpro"]}
        runs["sp-lg_depthpro"], launches["sp-lg_depthpro"] = prior_pipeline(
            dev, counted, "sp-lg_depthpro", conf, data, n, size["min_registered"], check_kernels=True)
        trainer, bconf, hd48_args = prior_trainer(dev, counted, size, data, tmp / "weights", f_px)
        launches["fit_scene_prior"] = trainer["launches"]
        if dev.type == "cuda":
            B, N, H, hd = hd48_args[0].shape
            k4["hd48"] = k4_check(f"K4 at the trained prior's attention ({B}x{N}x{H}x{hd} against "
                                  f"{hd48_args[1].shape[1]} keys, all real), float32, hd {hd} "
                                  "(attention_row_kernel<48>)", hd48_args)
        del hd48_args
        conf = merge_conf(VIT_MONO_CONF, {"extractors": {"depth_conf": bconf}})
        runs["vit_mono"], launches["vit_mono"] = prior_pipeline(dev, counted, "vit_mono", conf, data, n,
                                                                size["min_registered"])
    print(f"prior nets phase: {time.perf_counter() - t0:.1f} s wall")
    return dict(full=full, card_vs_cpu=gaps, trainer=trainer, pipelines=runs), launches, k4


# ---- the sparse BA solver (slice 8) ----

# the JAX package's 500+ image BA bench (scripts/bench_ba_large.py): __graft_entry__'s
# _synthetic_ba_data_sparse at 512 cameras × 131 072 points, each seen by 6 consecutive cameras of
# a sweep (786 432 observations; Pb·Cb = 67 M, 8.4× the dense layout's limit): the full-width BA
SPARSE = dict(n_cams=512, n_pts=131072, track_len=6)
# the refinement steps on the same sweep, with ImagePriors on B images at the main path's grid, cut to
# 128 × 65 536 (Pb·Cb = 8.4 M, still above the layout): at 256 and 512 cameras the point covariances'
# reduced camera system has modes below float32's resolution of its entries (sparse_covariance_gap)
SPARSE_ROUTE = dict(n_cams=128, n_pts=65536, track_len=6, B=8, H=290, W=387)
# the dense-Schur route at 192 cameras (K = 6C = 1152, Pb·Cb = 1.6 M, under DENSE_MAX): K1's grid route in situ
SPARSE_GRID_ROUTE = dict(n_cams=192, n_pts=8192)
# tests/test_ba.py::test_block_schur_full_solve_parity's bundle, for the card against the CPU
SPARSE_SMALL = dict(n_cams=16, n_pts=1024, track_len=4, seed=1)
# the start of both: rotation (rad) and translation noise of the poses, and the points' noise (each
# axis; the JAX bench's 0.05 is below what the BA itself leaves at 0.5 px over 0.5 of baseline, 0.07-0.08
# as a median, so moving toward the truth would not show)
SPARSE_POSE_NOISE, SPARSE_POINT_NOISE = (0.005, 0.025), 0.2
# right-hand sides on which K1 many is held to its plain version (and the float64 solve) at the
# covariances' shapes: the first 8192 points' 3 columns each (32 float64 solves over all would take minutes)
SPARSE_COV_COLS = 24576


def valid_slot_tables(ids, valid_rows, P):
    """Slot tables (P, K) over the valid rows only, vectorized (the JAX
    package's parallel/dist_ba._slot_tables_local)."""
    idx = np.where(valid_rows)[0]
    ids_v = np.asarray(ids)[idx]
    counts = np.bincount(ids_v, minlength=P) if len(ids_v) else np.zeros(P, np.int64)
    K = max(int(counts.max()) if len(ids_v) else 1, 1)
    slots = np.zeros((P, K), np.int32)
    mask = np.zeros((P, K), np.float32)
    if len(ids_v):
        order = np.argsort(ids_v, kind="stable")
        sorted_ids = ids_v[order]
        pos = np.arange(len(sorted_ids)) - np.searchsorted(sorted_ids, sorted_ids)
        slots[sorted_ids, pos] = idx[order]
        mask[sorted_ids, pos] = 1.0
    return slots, mask


def _rotmats(q):
    """(n,3,3) row-major rotations of (n,4) wxyz quaternions."""
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def sparse_scene(n_cams=256, n_pts=65536, track_len=6, seed=SEED):
    """The JAX package's large bundle (__graft_entry__._synthetic_ba_data_sparse)
    in numpy, with the same draws: a sweep of cameras 0.1 apart along x
    with a 0.001 rad yaw step, each point 4-9 in front of the middle
    camera of its track of track_len consecutive cameras, 0.5 px noise on
    every observation; log-depth rows (2% noise) on the first observation
    of every 4th point; the points' start 0.05 off. Returns the truth
    (quat, t, pts), the start xyz, the observations (cam, pt, uv, track
    k-th observation of point p at row k·P + p) and the depth rows."""
    rng = np.random.default_rng(seed)
    f, cx, cy = FOCAL, IMG_W / 2, IMG_H / 2
    quats = np.zeros((n_cams, 4), np.float32)
    quats[:, 0] = 1.0
    quats[:, 2] = 0.001 * np.arange(n_cams) / 2  # small-angle yaw
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    ts = np.stack([-0.1 * np.arange(n_cams), np.zeros(n_cams), np.zeros(n_cams)], -1).astype(np.float32)
    start = rng.integers(0, max(n_cams - track_len, 1), n_pts)
    mid = np.minimum(start + track_len // 2, n_cams - 1)
    local = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(4, 9, n_pts)],
                     -1).astype(np.float32)
    pts = np.einsum("nij,ni->nj", _rotmats(quats[mid]), local - ts[mid]).astype(np.float32)  # R_midᵀ (x − t_mid)
    cam_of, uv_of, z_of = [], [], []
    for k in range(track_len):
        c = np.minimum(start + k, n_cams - 1)
        w, x, y, z = quats[c].T
        R00, R01, R02 = 1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)
        R10, R11, R12 = 2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)
        R20, R21, R22 = 2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)
        px = R00 * pts[:, 0] + R01 * pts[:, 1] + R02 * pts[:, 2] + ts[c, 0]
        py = R10 * pts[:, 0] + R11 * pts[:, 1] + R12 * pts[:, 2] + ts[c, 1]
        pz = R20 * pts[:, 0] + R21 * pts[:, 1] + R22 * pts[:, 2] + ts[c, 2]
        u = f * px / pz + cx + rng.normal(scale=0.5, size=n_pts)
        v = f * py / pz + cy + rng.normal(scale=0.5, size=n_pts)
        cam_of.append(c)
        uv_of.append(np.stack([u, v], -1))
        z_of.append(pz)
    dsel = np.arange(0, n_pts, 4)
    d_log = (np.log(np.maximum(z_of[0][dsel], 1e-3)) + rng.normal(scale=0.02, size=len(dsel))).astype(np.float32)
    xyz = pts + rng.normal(scale=0.05, size=pts.shape).astype(np.float32)
    return SimpleNamespace(
        quat=quats, t=ts, pts=pts, xyz=xyz, start=start, track_len=track_len,
        obs_cam=np.concatenate(cam_of), obs_pt=np.tile(np.arange(n_pts), track_len),
        obs_uv=np.concatenate(uv_of).astype(np.float32),
        d_cam=np.minimum(start[dsel], n_cams - 1), d_pt=dsel, d_log=d_log,
    )


def sparse_ba_arrays(sc):
    """The scene as the fields of the JAX package's BAData (numpy), packed
    camera-major as _synthetic_ba_data_sparse packs them (no per-(point,
    camera) tables: the block-Schur tables come from the port's
    make_block_schur_tables)."""
    C, P = sc.quat.shape[0], sc.pts.shape[0]

    def pack(cam, n):
        order = np.argsort(cam, kind="stable")
        counts = np.bincount(cam, minlength=n)
        S = max(int(counts.max()), 1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rows = np.repeat(np.arange(n) * S, counts) + (np.arange(len(cam)) - np.repeat(starts, counts))
        return order, rows, S

    order, rows, Sc = pack(sc.obs_cam, C)
    No = C * Sc
    r_pt, r_uv, r_valid = np.zeros(No, np.int64), np.zeros((No, 2), np.float32), np.zeros(No, np.float32)
    r_pt[rows], r_uv[rows], r_valid[rows] = sc.obs_pt[order], sc.obs_uv[order], 1.0
    dorder, drows, Sd = pack(sc.d_cam, C)
    Nd = C * Sd
    d_pt, d_log, d_valid = np.zeros(Nd, np.int64), np.zeros(Nd, np.float32), np.zeros(Nd, np.float32)
    d_pt[drows], d_log[drows], d_valid[drows] = sc.d_pt[dorder], sc.d_log[dorder], 1.0
    cam_dof = np.ones((C, 6), np.float32)
    cam_dof[0] = 0.0
    cam_dof[1, 3] = 0.0
    f32 = np.float32
    arrays = dict(
        quat=sc.quat, t=sc.t, cam_dof=cam_dof, fx=np.full(C, FOCAL, f32), fy=np.full(C, FOCAL, f32),
        cx=np.full(C, IMG_W / 2, f32), cy=np.full(C, IMG_H / 2, f32), xyz=sc.xyz, point_var=np.ones(P, f32),
        r_cam=np.arange(No) // Sc, r_pt=r_pt, r_uv=r_uv, r_valid=r_valid, r_mag=r_valid.copy(),
        r_scale=np.full(No, 1.5, f32), d_cam=np.arange(Nd) // Sd, d_pt=d_pt, d_logtarget=d_log, d_valid=d_valid,
        d_mag=100.0 * d_valid, d_scale=np.full(Nd, 2.0, f32),
    )
    arrays["r_pt_slots"], arrays["r_pt_slot_mask"] = valid_slot_tables(r_pt, r_valid > 0, P)
    arrays["d_pt_slots"], arrays["d_pt_slot_mask"] = valid_slot_tables(d_pt, d_valid > 0, P)
    return arrays


def sparse_tables(arrays):
    """The port's make_block_schur_tables of BAData arrays (numpy)."""
    from mpsfm_tpu_torch.ba.schur_sparse import make_block_schur_tables

    return make_block_schur_tables(*(arrays[k] for k in ("r_pt", "r_cam", "r_valid", "d_pt", "d_cam", "d_valid")),
                                   arrays["xyz"].shape[0], arrays["quat"].shape[0])


def sparse_reconstruction(sc, B, H, W, device, pose_noise=SPARSE_POSE_NOISE, point_noise=SPARSE_POINT_NOISE,
                          seed=SEED):
    """A port Reconstruction of the scene on `device`: image i is the sweep's
    camera sc.cam_of[i] (see below), its keypoints its observations (by
    point), registered at its true pose perturbed by pose_noise (images 0
    and 1, the BA's gauge pair, exact), every point with its track,
    point_noise off the truth; the camera's integration grid H×W; and
    ImagePriors on B images spread over the sweep's cameras that see
    points, each from its own points (lane_prior). Returns (rec, pris).

    The BA fixes the pose of the bundle's first image and the x
    translation of its second (ba/problem.py), which pins the scale. With
    the sweep's first two cameras as that pair (0.1 apart on a sweep 0.1 ×
    C long) the scale is a soft mode of the reduced camera system (tx
    growing along the sweep: eigenvalue 0.249 at 64 cameras, 0.0259 at
    128, against a largest of 4e8 and 1e9), below float32's resolution of
    S at a few hundred cameras, where the point covariances' Cholesky
    meets a negative pivot. So image 1 is the sweep's last camera that
    sees points, as a mapper's gauge pair spans its scene: sc.cam_of =
    [0, last seen, 1, 2, ...]."""
    from mpsfm_tpu_torch.scene.reconstruction import HostCamera, ImageRecord, Pose, Reconstruction

    rng = np.random.default_rng(seed + 9)
    C, P = sc.quat.shape[0], sc.pts.shape[0]
    counts = np.bincount(sc.obs_cam, minlength=C)
    seen = np.flatnonzero(counts)  # the sweep's last cameras may see no point (the JAX package's draw)
    cam_of = np.concatenate([[0, seen[-1]], np.setdiff1d(np.arange(C), [0, seen[-1]])])
    sc.cam_of = cam_of
    imid_of = np.argsort(cam_of)
    obs_im = imid_of[sc.obs_cam]
    order = np.lexsort((sc.obs_pt, obs_im))
    icounts = counts[cam_of]
    starts = np.concatenate([[0], np.cumsum(icounts)[:-1]])
    kp_of = np.empty(len(order), np.int64)
    kp_of[order] = np.arange(len(order)) - starts[obs_im[order]]
    rec = Reconstruction()
    rec.add_camera(HostCamera(1, np.array([FOCAL, FOCAL, IMG_W / 2, IMG_H / 2]), int(IMG_W), int(IMG_H)))
    cam = rec.cameras[1]
    cam.int_width, cam.int_height = W, H
    for i, c in enumerate(cam_of.tolist()):
        im = ImageRecord(i, f"im{i:04d}.jpg", 1)
        im.keypoints = sc.obs_uv[order[starts[i]:starts[i] + icounts[i]]].astype(np.float64)
        im.point3D_ids = np.full(icounts[i], -1, np.int64)
        q, t = sc.quat[c].astype(np.float64), sc.t[c].astype(np.float64)
        if i >= 2:
            dq = np.concatenate([[1.0], rng.normal(scale=pose_noise[0], size=3)])
            dq /= np.linalg.norm(dq)
            q = np.array([dq[0] * q[0] - dq[1:] @ q[1:], *(dq[0] * q[1:] + q[0] * dq[1:] + np.cross(dq[1:], q[1:]))])
            t = t + rng.normal(scale=pose_noise[1], size=3)
        im.pose = Pose(q / np.linalg.norm(q), t)
        im.registered = True
        rec.add_image(im)
    ims = obs_im.reshape(sc.track_len, P)
    kps = kp_of.reshape(sc.track_len, P)
    xyz = sc.pts.astype(np.float64) + rng.normal(scale=point_noise, size=sc.pts.shape)
    for p in range(P):
        rec.add_point3D(xyz[p], list(zip(ims[:, p].tolist(), kps[:, p].tolist())))
    pris = []
    for c in seen[np.linspace(0, len(seen) - 1, B).round().astype(int)].tolist():
        i = int(imid_of[c])
        pids = rec.images[i].point3D_ids
        R = _rotmat(sc.quat[c].astype(np.float64))
        z = (sc.pts[pids].astype(np.float64) @ R.T + sc.t[c])[:, 2]
        pris.append(lane_prior(rec, i, z, H, W, rng, device))
    return rec, pris


def sparse_errors(rec, sc):
    """Median rotation (deg) and translation error of the cameras and
    median point error, against the truth."""
    rot, trans = [], []
    for i in sorted(rec.images):
        c = sc.cam_of[i]
        pose = rec.images[i].pose
        dq = abs(float(np.dot(pose.q, sc.quat[c] / np.linalg.norm(sc.quat[c]))))
        rot.append(np.rad2deg(2 * np.arccos(min(dq, 1.0))))
        trans.append(np.linalg.norm(pose.t - sc.t[c]))
    pids = rec.point_ids()
    return dict(rot=float(np.median(rot)), trans=float(np.median(trans)),
                pts=float(np.median(np.linalg.norm(rec.xyz[pids] - sc.pts[pids], axis=1))))


def sparse_dense_schur_route(dev, n_cams=FULL["n_cams"], n_pts=FULL["n_pts"], iters=LM_ITERS, against_dense=True):
    """solve_ba on the bundle of n_cams × n_pts with its per-(point, camera)
    tables (the dense-Schur route: K1 once per LM iteration, on its route at
    K = 6C) on the card, rel_tol 0: the cost down and the points closer to
    the truth (every camera sees every point), and with against_dense, the
    port's solve_ba_dense on the same bundle at
    tests/test_ba.py::test_dense_ba_matches_sparse's bounds; K1 held to its
    plain version on the reduced system with the largest right-hand side
    (last_call; the first step's: the last ones are near 0; k1_check_in_situ)
    and timed beside the library call. Returns the numbers printed, K1's
    launches by route ("launches") and its row of the kernels line ("k1")."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.ba import cholesky, dense, solver

    b = synthetic_bundle(n_cams, n_pts)
    truth = bench_points(n_pts)
    data = convert.ba_data(ba_arrays(b), device=dev)
    solver.solve_ba(data, max_iters=2, rel_tol=0.0)  # warm-up
    routes = {"cholesky": cholesky.KERNEL, "cholesky_grid": cholesky.KERNEL_GRID}
    n0 = {name: k.launches for name, k in routes.items()}
    with last_call(solver, "cholesky_solve", lambda a, out: float(a[1].abs().max())) as kept:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        q, t, x, info = solver.solve_ba(data, max_iters=iters, rel_tol=0.0)
        cost = float(info["cost"])
        wall = time.perf_counter() - t0
    launches = {name: k.launches - n0[name] for name, k in routes.items()}
    S, rhs = kept["args"]
    K = S.shape[0]
    own = "cholesky_grid" if cholesky.route(K) == "grid" else "cholesky"
    pts_err = [float(np.median(np.linalg.norm(np.asarray(a, np.float64) - truth, axis=1))) for a in (b.xyz, x.cpu())]
    line = (f"sparse BA, dense-Schur route ({n_cams} x {n_pts}, with per-(point, camera) tables): solve_ba "
            f"{iters} LM iterations in {wall:.4f} s wall, {iters / wall:.3f} LM iterations/s, K1 launches {launches} "
            f"(K={K}, {cholesky.route(K)} route); cost {float(info['cost0']):.6g} -> {cost:.6g} ({info['accepted']} "
            f"accepted)")
    ok = cost < float(info["cost0"]) and launches[own] == iters and sum(launches.values()) == iters
    gaps = {}
    if against_dense:
        _, td, xd, info_d = dense.solve_ba_dense(dense.densify(b, n_cams, n_pts, dev), max_iters=iters, rel_tol=0.0)
        gaps = dict(t=float((t - td).abs().max()), xyz=float((x - xd).abs().max()),
                    cost=abs(cost - float(info_d["cost"])) / float(info_d["cost"]))
        line += (f"; against solve_ba_dense: max|dt| {gaps['t']:.3e} (bound 5e-3), max|dxyz| {gaps['xyz']:.3e} "
                 f"(bound 2e-2), cost {gaps['cost']:.3e} relative (bound 5e-2)")
        ok = ok and gaps["t"] <= 5e-3 and gaps["xyz"] <= 2e-2 and gaps["cost"] <= 0.05
    line += f"; the points' median error to the truth {pts_err[0]:.4g} -> {pts_err[1]:.4g}"
    print(line)
    if not (ok and pts_err[1] < pts_err[0]):
        raise AssertionError(line)
    err, line = k1_check_in_situ(S, rhs, f"K1 at solve_ba's reduced system with the largest right-hand side (K={K}, "
                                 f"{cholesky.route(K)} route)")
    k1 = dict(k1_timed(S, rhs), err=err)
    print(f"{line}; kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.3f} ms, library {k1['library_ms']:.4f} ms, "
          f"bound {max(k1['ops_ms'], k1['bytes_ms']):.5f} ms; {launches[own]} launches x {k1['ms']:.4f} ms = "
          f"{launches[own] * k1['ms']:.3f} ms of K1 in {wall * 1e3:.1f} ms of solve_ba")
    return dict(lm_per_s=iters / wall, launches=launches, k1=k1, k1_ms=k1["ms"], k1_plain_ms=k1["plain_ms"], **gaps)


def k1_check_in_situ(S, rhs, what):
    """K1 on a BA's reduced system: held to its plain version by k1_check at
    K1_REL[0.01], unless the plain version itself lies farther than that from
    the float64 solve (its condition number printed); then by the float64
    rule of k1_many_check (K1_ILL_REL's note). Returns (max |Δx|, a line)."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    cond = float(torch.linalg.cond(S.double()))
    rel, res = f64_gaps(S, rhs, cholesky.cholesky_solve_plain(S, rhs))
    what = f"{what}, condition number {cond:.3g}, plain version {rel:.2e} relative from the float64 solve"
    if rel <= K1_REL[0.01] and res <= K1_REL[0.01]:
        _, err, line = k1_check(S, rhs, K1_REL[0.01], what)
        return err, line
    return k1_many_check(S, rhs, K1_ILL_REL, what, f64=True)


def check_sparse_refinement(out, kept_solve):
    """The large route's checks; raises on the first that fails."""
    cov = out["cov"].double().cpu().numpy()
    a, b, c = cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2]
    d, e, f = cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]
    minors = (a, a * d - b * b, a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d))
    asym = np.abs(cov - cov.transpose(0, 2, 1)).max() / np.abs(cov).max()
    if not (np.isfinite(cov).all() and asym < 1e-5 and all((m > 0).all() for m in minors)):
        raise AssertionError(f"sparse BA covariances not finite, symmetric ({asym}) or positive definite")
    if not (out["slots"] >= 0).all():
        raise AssertionError(f"{int((out['slots'] < 0).sum())} points have no slot in the parked covariances")
    for k in ("ba_global", "ba_local", "refine"):
        info, ok = out[k]
        if not (ok and info["cost"] < info["cost0"] and info["accepted"] >= 1):
            raise AssertionError(f"sparse BA {k}: {info}, success {ok}")
    data = (kept_solve["args"] or (None,))[0]
    if data is None or data.bs is None or data.pc_r_slot is not None:
        raise AssertionError("the global BA did not reach solve_ba with the block-sparse Schur tables")
    if not (np.isfinite(out["xyz"]).all() and np.isfinite(out["trunc"])):
        raise AssertionError(f"points or the truncation multiplier ({out['trunc']}) not finite")


def solve_ba_timed(data, cg_iters, dev):
    """solve_ba on `data` (after a 2-iteration warm-up), LM_ITERS
    iterations at rel_tol 0: (LM iterations/s, CG iterations per LM step,
    info). The wall includes its host reads."""
    import torch

    from mpsfm_tpu_torch.ba import solver

    solver.solve_ba(data, max_iters=2, rel_tol=0.0, cg_iters=cg_iters)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    info = solver.solve_ba(data, max_iters=LM_ITERS, rel_tol=0.0, cg_iters=cg_iters)[3]
    cg = info["cg_iters"].cpu().numpy()
    return LM_ITERS / (time.perf_counter() - t), cg, info


def sparse_large_route(dev, counted, size=SPARSE_ROUTE):
    """The refinement steps of the JAX Mapper (run_scene_refinement) on the
    sweep above the dense layout: point covariances (K1 many at K = 6·Cb),
    the global step (integration (K2), int_covs (K3), ba_fused falling
    back to finalize_deferred_all, the host depth rows and solve_ba on the
    block-sparse Schur tables), the local step (dense: K1) and
    refine_3d_points (the same fallback, poses fixed), with the launch
    counts at 0. No warm-up run of its own (cut to keep the script near
    400 s): the scene refinement, mapping and pipeline phases before it
    ran these entry points on the card. Checks
    (check_sparse_refinement), the truth's errors before and after, one
    wall line per entry point, build_ba_data's host time with
    make_block_schur_tables apart, the peak device memory, launches; on the
    card each kernel held to its plain version at the route's shapes
    (check_path_kernels) and solve_ba timed on the global BA's problem.
    Returns (numbers, launches)."""
    import gc

    import torch

    from mpsfm_tpu_torch.mapper import optimizer as topt

    dev = torch.device(dev)
    sc = sparse_scene(size["n_cams"], size["n_pts"], size["track_len"])
    t = time.perf_counter()
    rec, pris = sparse_reconstruction(sc, size["B"], size["H"], size["W"], dev)
    build_s = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = sparse_errors(rec, sc)
    for k in counted.values():
        k.launches = 0
    times = {}
    with path_kernel_args() as kept, \
            last_call(topt, "solve_ba", lambda a, out: float(a[0].cam_dof.sum())) as kept_solve:
        t = time.perf_counter()
        out = run_scene_refinement(rec, pris, dev, times)
        wall = time.perf_counter() - t
    launches = {name: k.launches for name, k in counted.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else float("nan")
    check_sparse_refinement(out, kept_solve)
    after = sparse_errors(rec, sc)
    C, P = sc.quat.shape[0], sc.pts.shape[0]
    data = kept_solve["args"][0]
    Cb, Pb = data.quat.shape[0], data.xyz.shape[0]
    print(f"sparse BA, large route: {C} images x {P} points (tracks of {size['track_len']}, {sc.obs_cam.size} "
          f"observations; Pb x Cb = {Pb * Cb} against the dense layout's 8000000), ImagePriors on {len(pris)} images "
          f"at {size['H']}x{size['W']} (scene and priors built in {build_s:.3f} s); {wall:.3f} s wall; peak device "
          f"memory {peak:.2f} GiB; launches {json.dumps(launches)}")
    for k in ("ba_global", "ba_local", "refine"):
        info = out[k][0]
        print(f"sparse BA {k}: cost {info['cost0']:.6g} -> {info['cost']:.6g}, {info['accepted']} accepted")
    print(f"sparse BA, large route: median errors to the truth before {before}, after {after} (not held: the "
          f"planar priors of a point cloud pull the sweep's soft modes); truncation multiplier {out['trunc']:.6g}; "
          f"the global BA's tables: {len(data.bs.con_a)} buckets, {int(data.bs.blk_rows.shape[0])} blocks, Tu "
          f"{int(data.bs.uni_slots.shape[1])}")
    for name, sec in times.items():
        print(f"sparse BA {name}: {sec:.4f} s wall")
    if unlaunched(launches):
        raise AssertionError(f"kernels {unlaunched(launches)} were not launched in the sparse BA large route")
    res = dict(wall=wall, peak_gib=peak, launches=launches, before=before, after=after, times=times)
    if dev.type == "cuda":
        res["kernels"] = check_path_kernels("sparse BA large route", kept, rec, dev, pris=pris,
                                            many_cols=SPARSE_COV_COLS, k2_budget=True)
        res["lm_per_s"], cg, info = solve_ba_timed(data, kept_solve["kw"]["cg_iters"], dev)
        print(f"sparse BA solve_ba on the large route's global BA problem (block-sparse Schur, {Cb} x {Pb}): "
              f"{res['lm_per_s']:.3f} LM iterations/s; CG iterations per LM step {cg.tolist()} (mean {cg.mean():.2f}); "
              f"cost {float(info['cost0']):.6g} -> {float(info['cost']):.6g}, {info['accepted']} accepted")
    del kept, kept_solve, rec, pris, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res, launches


def truth_cost(prob, sc):
    """The problem's cost (_cost_only, the BA's losses) at the true poses
    and points: a converged BA's cost is at or below it."""
    import torch

    from mpsfm_tpu_torch.ba import losses, solver

    d = prob.data
    Cb, Pb = d.quat.shape[0], d.xyz.shape[0]
    cams = sc.cam_of[np.asarray(prob.cam_ids)]
    q = np.zeros((Cb, 4), np.float32)
    q[:, 0] = 1.0
    q[:len(cams)] = sc.quat[cams]
    t = np.zeros((Cb, 3), np.float32)
    t[:len(cams)] = sc.t[cams]
    x = np.zeros((Pb, 3), np.float32)
    x[:prob.n_pts] = sc.pts[prob.pt_ids]
    dev = d.xyz.device
    return float(solver._cost_only(d, *(torch.as_tensor(a, device=dev) for a in (q, t, x)), losses.SOFT_L1,
                                   losses.CAUCHY))


def sparse_covariance_gap(rec, dev):
    """The point covariances' reduced camera system S + 1e-8·I of rec's
    global bundle, as ba/covariance.py forms it in float32 (the JAX
    package's algorithm): its smallest eigenvalues in float64, and the
    share of finite covariances Optimizer.calculate_point_covs parks.
    Returns (eigenvalues, finite share, K, N)."""
    import torch

    from mpsfm_tpu_torch.ba import covariance
    from mpsfm_tpu_torch.mapper.optimizer import Optimizer

    with last_call(covariance, "cholesky_solve", lambda a, out: a[1].numel()) as kept:
        Optimizer({}, rec, device=dev).calculate_point_covs(global_bundle(rec))
    cov = rec.point_covs.device_view()[0]
    S, Bm = kept["args"]
    ev = torch.linalg.eigvalsh(S.double())[:8].cpu().numpy()
    return ev, float(torch.isfinite(cov).all(dim=(1, 2)).double().mean()), S.shape[0], Bm.shape[1]


def sparse_full_width(dev, counted, size=SPARSE):
    """The JAX package's 500+ image BA bench as a Reconstruction (sweep
    cameras perturbed, points 0.2 off, no priors) through the Optimizer's
    entry points on the card, the launch counts at 0 just before:
    Optimizer.ba (the global bundle above the dense layout: block-sparse
    Schur tables, solve_ba) and refine_3d_points (ba_fused's fallback,
    poses fixed). Held: solve_ba on the block-sparse tables; the cost
    below its start and at or below the cost at the truth (the optimum
    is); refine_3d_points leaves the poses. The errors to the truth are
    printed, not held: the sweep's soft modes (scale and bending along
    512 cameras) put the optimum itself farther from the truth than the
    start (rotations 0.87 -> 1.58 deg, PERF.md). Then the point
    covariances at this size (sparse_covariance_gap, printed; K1 many at
    their shape is timed in k1_many_phase); solve_ba timed on the global
    BA's problem. Returns (numbers, launches)."""
    import gc

    import torch

    from mpsfm_tpu_torch.mapper import optimizer as topt
    from mpsfm_tpu_torch.utils.profiling import TIMERS

    dev = torch.device(dev)
    sc = sparse_scene(size["n_cams"], size["n_pts"], size["track_len"])
    t = time.perf_counter()
    rec, _ = sparse_reconstruction(sc, 0, 1, 1, dev)
    build_s = time.perf_counter() - t
    before = sparse_errors(rec, sc)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for k in counted.values():
        k.launches = 0
    TIMERS.reset()
    opt = topt.Optimizer({}, rec, device=dev)
    bundle = global_bundle(rec)
    times = {}
    with last_call(topt, "solve_ba", lambda a, out: float(a[0].cam_dof.sum())) as kept_solve, \
            last_call(topt, "apply_ba_result", lambda a, out: float(a[1].data.cam_dof.sum())) as kept_prob:
        for name, fn in (("Optimizer.ba", opt.ba), ("refine_3d_points", opt.refine_3d_points)):
            q0 = {i: rec.images[i].pose.q.copy() for i in rec.images}
            t = time.perf_counter()
            info, ok = fn(bundle)
            times[name] = time.perf_counter() - t
            if name == "Optimizer.ba":
                ba_info, after = info, sparse_errors(rec, sc)
                gt_cost = truth_cost(kept_prob["args"][1], sc)
            elif not (ok and info["cost"] <= info["cost0"]
                      and all(np.abs(rec.images[i].pose.q - q0[i]).max() <= 1e-6 for i in rec.images)):
                raise AssertionError(f"refine_3d_points above the dense layout: {info}, success {ok}")
    launches = {name: k.launches for name, k in counted.items()}
    times["build_ba_data"] = TIMERS.totals["ba.build_data"]
    times["make_block_schur_tables (in build_ba_data)"] = TIMERS.totals["ba.block_schur_tables"]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else float("nan")
    data = kept_solve["args"][0]
    Cb, Pb = data.quat.shape[0], data.xyz.shape[0]
    line = (f"sparse BA, full width: {sc.quat.shape[0]} images x {sc.pts.shape[0]} points (tracks of "
            f"{size['track_len']}, {sc.obs_cam.size} observations; Pb x Cb = {Pb * Cb}; built in {build_s:.3f} s): "
            f"Optimizer.ba cost {ba_info['cost0']:.6g} -> {ba_info['cost']:.6g} ({ba_info['accepted']} accepted; "
            f"at the truth {gt_cost:.6g}); median errors to the truth before {before}, after {after}; peak device "
            f"memory {peak:.2f} GiB; launches {json.dumps(launches)}")
    print(line)
    if not (data.bs is not None and data.pc_r_slot is None and ba_info["cost"] < ba_info["cost0"]
            and ba_info["cost"] <= gt_cost):
        raise AssertionError(line)
    for name, sec in times.items():
        print(f"sparse BA full width {name}: {sec:.4f} s wall")
    res = dict(times=times, before=before, after=after, peak_gib=peak, launches=launches, cost=ba_info["cost"],
               truth_cost=gt_cost)
    if dev.type == "cuda":
        res["lm_per_s"], cg, info = solve_ba_timed(data, kept_solve["kw"]["cg_iters"], dev)
        res["cg_per_lm"] = float(cg.mean())
        print(f"sparse BA solve_ba on the full-width global BA problem (block-sparse Schur, {Cb} x {Pb}): "
              f"{res['lm_per_s']:.3f} LM iterations/s; CG iterations per LM step {cg.tolist()} (mean {cg.mean():.2f}); "
              f"cost {float(info['cost0']):.6g} -> {float(info['cost']):.6g}, {info['accepted']} accepted")
        del kept_solve, kept_prob, data
        ev, finite, K, N = sparse_covariance_gap(rec, dev)
        print(f"sparse BA full width, point covariances (K={K}, N={N}): the smallest eigenvalues of S + 1e-8 I "
              f"(float64 of its float32 entries) {[float(f'{v:.3g}') for v in ev]}; finite covariances {finite:.4f} "
              f"of the points")
        res["cov_eigs"], res["cov_finite"] = ev.tolist(), finite
    del rec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res, launches


def sparse_card_vs_cpu(dev, size=SPARSE_SMALL, iters=10):
    """solve_ba at tests/test_ba.py::test_block_schur_full_solve_parity's
    size (16 × 1024, tracks of 4) with the block-sparse Schur tables on the
    card and on the CPU, and without them (matrix-free) on the card: every
    final cost within 2% + 1e-3 of the CPU's, and a tenfold drop."""
    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.ba import solver

    arrays = sparse_ba_arrays(sparse_scene(**size))
    bs = sparse_tables(arrays)
    costs = {}
    for name, d, tables in (("CPU, block-sparse Schur", "cpu", bs), ("card, block-sparse Schur", dev, bs),
                            ("card, matrix-free", dev, None)):
        info = solver.solve_ba(convert.ba_data({**arrays, "bs": tables}, device=d), max_iters=iters)[3]
        costs[name] = (float(info["cost0"]), float(info["cost"]))
    ref = costs["CPU, block-sparse Schur"][1]
    line = (f"sparse BA, small ({size['n_cams']} x {size['n_pts']}, tracks of {size['track_len']}), {iters} LM "
            f"iterations, cost0 -> cost: " + "; ".join(f"{k} {a:.6g} -> {b:.6g}" for k, (a, b) in costs.items())
            + f" (each within 2% + 1e-3 of the CPU's)")
    print(line)
    if not all(abs(c - ref) <= 0.02 * ref + 1e-3 and c < 0.1 * c0 for c0, c in costs.values()):
        raise AssertionError(line)
    return costs


def sparse_ba_phase(dev, counted):
    """Slice 8, the sparse BA solver on the card: the dense-Schur route at
    the bench bundle (sparse_dense_schur_route), the refinement steps above
    the dense layout (sparse_large_route), the full-width BA
    (sparse_full_width), and the card against the CPU at a small size
    (sparse_card_vs_cpu); the dense-Schur route again at SPARSE_GRID_ROUTE,
    where K1 takes its grid route in situ. Returns (numbers, {route:
    launches})."""
    out = {"dense_schur": sparse_dense_schur_route(dev)}
    # the dense-Schur route at SPARSE_GRID_ROUTE: K1 in situ on its grid route (K = 6C above GRID_MIN_K)
    t = time.perf_counter()
    out["dense_schur_grid"] = sparse_dense_schur_route(dev, **SPARSE_GRID_ROUTE, against_dense=False)
    print(f"sparse BA, dense-Schur route at {SPARSE_GRID_ROUTE}: {time.perf_counter() - t:.1f} s wall with its checks")
    out["large"], large = sparse_large_route(dev, counted)
    out["full"], full = sparse_full_width(dev, counted)
    out["small"] = sparse_card_vs_cpu(dev)
    return out, {"dense-Schur route (grid)": out["dense_schur_grid"]["launches"], "large route": large,
                 "full width": full}


# ---- the distributed BA (slice 9): parallel/ over torch.distributed, in worker processes ----

# LM iterations at rel_tol 0 of (a), the full-width sweep, and of (b), the bench bundle, at
# tests/test_parallel.py's bounds. (a) converges in DIST_DECIDED steps (9.39e6 -> 275 035 on the card);
# after them the cost sits at float32's resolution of it (1e-7), where the order of the sums decides
# whether a step is taken (H100: the sharded solve took [1, 1, 0, 1, 1], solve_ba [1, 1, 1, 1, 0]), so
# the decisions are held over the first DIST_DECIDED steps
DIST_FULL_ITERS, DIST_BENCH_ITERS, DIST_DECIDED = 5, 10, 2
# (c), the twin of tests/multihost_mapper_worker.py: its PlaneScene (MappingScene: seed 3, 5 images ×
# 120 points) and mapper conf, the global BAs sharded over the ranks whatever their size
DIST_MAPPER = dict(seed=3, n_images=5, n_points=120, num_hyp=64)
DIST_MAPPER_CONF = {"verbose": 0, "ba": {"max_iters": 6, "dist_ba": "on"}, "registration": {"num_hyp": 64}}
DIST_WORKER_TIMEOUT = 300  # seconds a job's ranks may take; a rank stuck in a collective fails the phase
# the bundles of (a) and (b): on the card, and for a rehearsal of the phase on the CPU
DIST_SIZES = {"full": (SPARSE, FULL), "small": (SPARSE_SMALL, SMALL)}


def k1_row(S, rhs, what):
    """K1 held to its plain version on (S, rhs) (k1_check, K1_REL[0.01]), timed
    beside the plain version and the library call, with its bound: a row of the
    kernels line, and the line to print ("line")."""
    _, err, line = k1_check(S, rhs, K1_REL[0.01], what)
    if not S.is_cuda:  # a rehearsal on the CPU: the plain version against itself, no time
        return dict(err=err, line=line)
    t = k1_timed(S, rhs)
    return dict(t, err=err, line=f"{line}; kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, library "
                               f"{t['library_ms']:.4f} ms")


def mapper_decisions(rec, ok, mapper):
    """What ranks that map replicated must agree on: the registered images
    and their order, points per image and in all, poses (as float lists, so
    equal means bit for bit), and how many BAs ran sharded."""
    reg_ids = sorted(int(i) for i, im in rec.images.items() if im.registered)
    return {
        "ok": bool(ok), "registered": reg_ids,
        "order": [int(i) for i in mapper.nextview.registration_order if i is not None],
        "dist_solves": int(mapper.optimizer.dist_solves),
        "points_per_image": {str(i): int(rec.images[i].num_points3D()) for i in reg_ids},
        "num_points3D": int(rec.num_points3D()),
        "poses": {str(i): np.concatenate([rec.images[i].pose.q, rec.images[i].pose.t]).tolist() for i in reg_ids},
    }


def run_dist_mapper(dev, dist_ba, shards=0):
    """MpsfmMapper on `dev` over DIST_MAPPER's scene with DIST_MAPPER_CONF
    (dist_ba and dist_ba_shards set). Returns (mapper_decisions, wall s, ATE)."""
    import torch

    from mpsfm_tpu_torch.mapper import MpsfmMapper

    dev = torch.device(dev)
    rec, corr, truth, _, _ = mapping_state(dev, **DIST_MAPPER)
    conf = {**DIST_MAPPER_CONF, "ba": {**DIST_MAPPER_CONF["ba"], "dist_ba": dist_ba, "dist_ba_shards": shards}}
    mapper = MpsfmMapper(conf, rec, corr, device=dev)
    t = time.perf_counter()
    rec, ok = mapper()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t
    ate = ate_rmse(rec, truth["poses"]) if rec.num_reg_images() >= 3 else float("inf")
    return mapper_decisions(rec, ok, mapper), wall, ate


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dist_solve(parts, dev, iters, warm=True):
    """solve_ba_block_sharded over the default group at rel_tol 0, timed
    (after a one-iteration warm-up): (quat, t, the gathered point blocks,
    info with K1's launches in the timed solve, wall s), as numpy."""
    from mpsfm_tpu_torch.parallel import dist_ba

    group = dist_ba.make_group()
    if warm:
        dist_ba.solve_ba_block_sharded(parts, group, max_iters=1, rel_tol=0.0, device=dev)
    n0 = k1_launched()
    sync(dev)
    t = time.perf_counter()
    q, tt, x, info = dist_ba.solve_ba_block_sharded(parts, group, max_iters=iters, rel_tol=0.0, device=dev)
    info["cost"], info["cost0"] = float(info["cost"]), float(info["cost0"])
    wall = time.perf_counter() - t
    info["cost_history"] = info["cost_history"].cpu().numpy()
    info["k1_launches"] = k1_launched() - n0
    return q.cpu().numpy(), tt.cpu().numpy(), dist_ba.all_gather_points(x, group).cpu().numpy(), info, wall


def solve_ba_reference(data, dev, iters):
    """The port's solve_ba on one device, rel_tol 0, timed after a warm-up."""
    from mpsfm_tpu_torch.ba import solver

    solver.solve_ba(data, max_iters=1, rel_tol=0.0)
    sync(dev)
    t = time.perf_counter()
    q, tt, x, info = solver.solve_ba(data, max_iters=iters, rel_tol=0.0)
    cost = float(info["cost"])
    return dict(quat=q.cpu().numpy(), t=tt.cpu().numpy(), xyz=x.cpu().numpy(), cost0=float(info["cost0"]),
                cost=cost, accepted=info["accepted"], wall=time.perf_counter() - t,
                cost_history=info["cost_history"].cpu().numpy())


def dist_job_full(dev, rank, size):
    """(a) On a world-size-1 NCCL group: solve_ba_block_sharded on the
    full-width sweep (SPARSE: 512 × 131 072, the numpy copy of
    _synthetic_ba_data_sparse, the block-Schur route), and the port's
    solve_ba (its block-Schur tables) on the same data; the cost at the
    truth with the BA's losses."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.ba import losses, solver
    from mpsfm_tpu_torch.parallel import dist_ba

    sc = sparse_scene(**DIST_SIZES[size][0])
    arrays = sparse_ba_arrays(sc)
    t = time.perf_counter()
    parts, pids = dist_ba.partition_ba_data(SimpleNamespace(**arrays), 1)
    part_s = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    q, tt, x, info, wall = dist_solve(parts, dev, DIST_FULL_ITERS)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else float("nan")
    del parts
    data = convert.ba_data({**arrays, "bs": sparse_tables(arrays)}, device=dev)
    ref = solve_ba_reference(data, dev, DIST_FULL_ITERS)
    truth = float(solver._cost_only(data, *(torch.as_tensor(a, device=dev) for a in (sc.quat, sc.t, sc.pts)),
                                    losses.SOFT_L1, losses.CAUCHY))
    return dict(info=info, wall=wall, partition_s=part_s, peak=peak,
                backend=torch.distributed.get_backend(),
                ref={k: v for k, v in ref.items() if k not in ("quat", "t", "xyz")}, truth=truth,
                n_bs_buckets=len(data.bs.con_a), P=sc.pts.shape[0], C=sc.quat.shape[0])


def dist_job_pair(dev, rank, size):
    """(b) and (c) on one of two gloo ranks sharing the card. (b): the
    bench bundle (64 × 8192) partitioned over the two ranks on the
    block-Schur and on the dense-T route (MPSFM_DIST_BS=0), each solved
    with the K1 launches counted around it; rank 0 keeps the dense-T
    route's last reduced system (for K1 against its plain version) and
    solves the bundle with solve_ba. (c): the mapper twin with dist_ba on,
    the kernel launches counted around it."""
    import os

    from mpsfm_tpu_torch import convert, kernels
    from mpsfm_tpu_torch.ba import solver
    from mpsfm_tpu_torch.parallel import dist_ba

    bench = DIST_SIZES[size][1]
    arrays = ba_arrays(synthetic_bundle(bench["n_cams"], bench["n_pts"]))
    out = {"routes": {}, "bench": (bench["n_cams"], bench["n_pts"])}
    for route, flag in (("block-Schur", "1"), ("dense-T", "0")):
        os.environ["MPSFM_DIST_BS"] = flag
        try:
            t = time.perf_counter()
            parts, pids = dist_ba.partition_ba_data(SimpleNamespace(**arrays), 2)
            part_s = time.perf_counter() - t
        finally:
            del os.environ["MPSFM_DIST_BS"]
        with last_call(solver, "cholesky_solve", lambda a, o: float(a[1].abs().max())) as kept:
            q, tt, x, info, wall = dist_solve(parts, dev, DIST_BENCH_ITERS)
        out["routes"][route] = dict(quat=q, t=tt, xyz=dist_ba.unpartition_points(x, pids, arrays["xyz"].shape[0]),
                                    info=info, wall=wall, partition_s=part_s, k1_launches=info["k1_launches"],
                                    tables="n_bs_buckets" in parts)
        if route == "dense-T" and rank == 0:
            S, rhs = kept["args"]
            out["k1"] = k1_row(S, rhs, f"K1 at the sharded dense-T route's reduced system with the largest "
                                       f"right-hand side (K={S.shape[0]})")
    if rank == 0:
        out["single"] = solve_ba_reference(convert.ba_data(arrays, device=dev), dev, DIST_BENCH_ITERS)
    # the mapper's kernels (K4's two, float32 and tensor-core bfloat16, are LightGlue's)
    counted = [k for k in kernels.all_kernels() if k.name not in ("attention", "attention_tc")]
    for k in counted:
        k.launches = 0
    decisions, wall, ate = run_dist_mapper(dev, "on", 2)
    out["mapper"] = dict(decisions, wall=wall, ate=ate, launches={k.name: k.launches for k in counted})
    return out


def dist_worker(job, rank, world, port, outdir, device, size):
    """`chip_smoke.py --dist-worker <job> <rank> <world> <port> <dir>
    <device> <size>`: one rank of the distributed BA phase on `device`
    (cuda:0; cpu for a rehearsal at DIST_SIZES["small"]). Job "full" is (a)
    on a world-size-1 group, NCCL on the card; job "pair" is (b) and (c) on
    one of two gloo ranks sharing the device (NCCL refuses two ranks on one
    card; gloo sums CUDA tensors through the host). Pickles its results
    into <dir>/<job><rank>.pkl; a failure exits non-zero."""
    import os
    import pickle

    import torch

    from mpsfm_tpu_torch.parallel import multihost

    rank, world = int(rank), int(world)
    dev = torch.device(device)
    # job "full" takes the device's backend (NCCL on a card), "pair" gloo
    multihost.initialize_multihost(f"tcp://localhost:{port}", world, rank, device=dev,
                                   backend=None if job == "full" else "gloo")
    try:
        out = (dist_job_full if job == "full" else dist_job_pair)(dev, rank, size)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(outdir, f"{job}{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


def run_dist_workers(job, world, outdir, device, size):
    """Starts `world` ranks of `job` (dist_worker), waits for all of them
    (DIST_WORKER_TIMEOUT; every rank is killed before this returns or
    raises) and returns their results in rank order; a rank that fails
    fails the phase with its output."""
    import os
    import pickle
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # the host's cores shared out over the ranks (unless the caller set it): each rank's torch would
    # otherwise take them all, and ranks that wait on each other in collectives then crawl
    env = {**os.environ, "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker", job, str(r), str(world),
                               str(port), outdir, str(device), size], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"distributed BA phase, job {job}: rank {r} exited {p.returncode}:\n{o[-4000:]}")
    res = []
    for r in range(world):
        with open(os.path.join(outdir, f"{job}{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def taken(cost0, hist):
    """Which LM steps were taken (the cost history moved), as 0/1."""
    return (np.diff(np.concatenate([[cost0], hist])) < 0).astype(int).tolist()


def check_dist_full(full, job_wall):
    """(a)'s checks: cost0 of the sharded solve and of solve_ba within 1e-5
    relative, the final costs within 1e-3 of each other
    (test_block_sharded_ba_matches_single_device's bounds) and both at or
    below the cost at the truth, and the same decisions (the same steps
    taken and refused by both over the first DIST_DECIDED)."""
    info, ref, iters = full["info"], full["ref"], DIST_FULL_ITERS
    steps, ref_steps = taken(info["cost0"], info["cost_history"]), taken(ref["cost0"], ref["cost_history"])
    line = (f"distributed BA (a), full width on a world-size-1 {full['backend']} group (one rank: not a multi-card time): "
            f"{full['C']} images x {full['P']} points, block-Schur route ({full['n_bs_buckets']} buckets in solve_ba's "
            f"tables); partition_ba_data {full['partition_s']:.3f} s; solve_ba_block_sharded {iters} LM iterations in "
            f"{full['wall']:.4f} s ({iters / full['wall']:.3f} LM iterations/s), cost {info['cost0']:.6g} -> "
            f"{info['cost']:.6g} (steps taken {steps}), {info['all_reduces']} all-reduces, "
            f"{info['all_reduce_bytes'] / info['steps']:.0f} bytes per LM step, peak device memory {full['peak']:.2f} "
            f"GiB; solve_ba {ref['wall']:.4f} s ({iters / ref['wall']:.3f} LM iterations/s), cost {ref['cost0']:.6g} -> "
            f"{ref['cost']:.6g} (steps taken {ref_steps}); cost at the truth {full['truth']:.6g}; job {job_wall:.3f} s "
            f"wall with the process start")
    print(line)
    if not (abs(info["cost0"] - ref["cost0"]) <= 1e-5 * ref["cost0"] and info["cost"] <= full["truth"]
            and ref["cost"] <= full["truth"] and abs(info["cost"] - ref["cost"]) <= 1e-3 * ref["cost"]
            and steps[:DIST_DECIDED] == ref_steps[:DIST_DECIDED] and sum(steps) >= 1):
        raise AssertionError(line)


def check_dist_pair(ranks, job_wall, dev):
    """(b)'s checks on each route: the two ranks' results bit for bit; the
    route taken (block-Schur tables, or the dense T with K1 launched every
    step on both ranks on the card); against solve_ba at
    tests/test_parallel.py::test_block_sharded_ba_matches_single_device's
    bounds. Returns K1's launches on the dense-T route (rank 0)."""
    single = ranks[0]["single"]
    for route in ("block-Schur", "dense-T"):
        a, b = (r["routes"][route] for r in ranks)
        info = a["info"]
        same = all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in ("quat", "t", "xyz")) and all(
            np.array_equal(np.asarray(a["info"][k]), np.asarray(b["info"][k])) for k in ("cost0", "cost", "cost_history"))
        gaps = dict(cost0=abs(info["cost0"] - single["cost0"]) / single["cost0"],
                    cost=abs(info["cost"] - single["cost"]) / single["cost"],
                    quat=float(np.abs(a["quat"] - single["quat"]).max()),
                    xyz=float(np.abs(a["xyz"] - single["xyz"]).max()))
        line = (f"distributed BA (b), two gloo ranks on one card (not a multi-card time), bench bundle "
                f"({' x '.join(map(str, ranks[0]['bench']))}), {route} route: partition_ba_data {a['partition_s']:.3f} s; "
                f"{DIST_BENCH_ITERS} LM iterations in {a['wall']:.4f} / {b['wall']:.4f} s (ranks 0 / 1), cost "
                f"{info['cost0']:.6g} -> {info['cost']:.6g} ({info['accepted']} accepted), {info['all_reduces']} "
                f"all-reduces, {info['all_reduce_bytes'] / info['steps']:.0f} bytes per LM step, K1 launches "
                f"{a['k1_launches']} / {b['k1_launches']}; ranks bit-identical {same}; against solve_ba "
                f"({single['wall']:.4f} s): cost0 {gaps['cost0']:.2e} (bound 1e-5), cost {gaps['cost']:.2e} (1e-3), "
                f"quat {gaps['quat']:.2e} (1e-5), xyz {gaps['xyz']:.2e} (1e-3)")
        print(line)
        dense = route == "dense-T"
        if not (same and a["tables"] != dense and gaps["cost0"] <= 1e-5 and gaps["cost"] <= 1e-3
                and gaps["quat"] <= 1e-5 and gaps["xyz"] <= 1e-3
                and a["k1_launches"] == b["k1_launches"] == (info["steps"] if dense and dev.type == "cuda" else 0)):
            raise AssertionError(line)
    print(f"distributed BA (b): job {job_wall:.3f} s wall with the process start and (c)")
    return ranks[0]["routes"]["dense-T"]["k1_launches"]


def check_dist_mapper(ranks, dev):
    """(c)'s checks: both ranks mapped, with a sharded BA, the same
    decisions (registered images and order, points per image and in all,
    poses bit for bit); against one process with dist_ba off on the card:
    the same images in the same order, points within max(3, 2%)
    (tests/test_parallel.py::test_mapper_e2e_with_distributed_ba)."""
    v0, v1 = (r["mapper"] for r in ranks)
    one, wall, ate = run_dist_mapper(dev, "off")
    keys = ("ok", "registered", "order", "points_per_image", "num_points3D", "poses")
    same = all(v0[k] == v1[k] for k in keys)
    line = (f"distributed BA (c), the mapper on two gloo ranks on one card, dist_ba on ({DIST_MAPPER['n_images']} "
            f"images x {DIST_MAPPER['n_points']} points, seed {DIST_MAPPER['seed']}): order {v0['order']} / "
            f"{v1['order']}, points {v0['num_points3D']} / {v1['num_points3D']}, {v0['dist_solves']} sharded BAs, "
            f"ranks identical (poses bit for bit) {same}, wall {v0['wall']:.3f} / {v1['wall']:.3f} s, ATE "
            f"{v0['ate']:.5f}, launches {json.dumps(v0['launches'])}; one process, dist_ba off: order {one['order']}, "
            f"points {one['num_points3D']}, wall {wall:.3f} s, ATE {ate:.5f}")
    print(line)
    if not (same and v0["ok"] and v0["dist_solves"] > 0 and len(v0["registered"]) == DIST_MAPPER["n_images"]
            and one["order"] == v0["order"] and one["registered"] == v0["registered"] and one["dist_solves"] == 0
            and abs(one["num_points3D"] - v0["num_points3D"]) <= max(3, 0.02 * one["num_points3D"])):
        raise AssertionError(line)


def dist_ba_phase(dev, size="full"):
    """Slice 9, the distributed BA, in worker processes of this script (the
    main process never holds a process group): (a) on a world-size-1 NCCL
    group, solve_ba_block_sharded at full width against solve_ba; (b) two
    gloo ranks sharing the card on the bench bundle, both routes, with K1
    held to its plain version at the dense-T route's reduced system; (c)
    the mapper twin of tests/multihost_mapper_worker.py on the same two
    ranks, against one process. Neither (a) nor (b, c) is a multi-card
    measurement. Returns (K1's row at the sharded dense-T route, its
    launches there, the mapper's launches on rank 0)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        (full,) = run_dist_workers("full", 1, tmp, dev, size)
        full_wall = time.perf_counter() - t
        t = time.perf_counter()
        pair = run_dist_workers("pair", 2, tmp, dev, size)
        pair_wall = time.perf_counter() - t
    check_dist_full(full, full_wall)
    k1_launches = check_dist_pair(pair, pair_wall, dev)
    print(f"distributed BA (b), rank 0: {pair[0]['k1']['line']}")
    check_dist_mapper(pair, dev)
    return pair[0]["k1"], k1_launches, pair[0]["mapper"]["launches"]


def profile_slice(inputs, dev, top=12):
    """Device time of one main-path run by kernel (torch.profiler), and the
    device's busy share of the run's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run_slice(inputs, dev)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t) * 1e6
    by_name = {}
    launches = 0
    for e in prof.events():  # device-side events: kernels and copies
        launches += e.name in ("cudaLaunchKernel", "cudaLaunchCooperativeKernel")
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    rows = sorted(((k, n, us) for k, (n, us) in by_name.items()), key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    print(f"profile: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / wall_us:.1f}% of wall), {launches} kernel launches from the host"
          if busy else "profile: no device time recorded")
    for name, n, us in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  x{n:<6d} {name[:90]}")


def ptxas_notes(log):
    """ptxas's register and spill lines of an nvcc -Xptxas -v log, each
    after its kernel's mangled name."""
    notes, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            entry = re.search(r"'(\w+)'", ln).group(1)
        elif entry and ("registers" in ln or "spill" in ln):
            notes.append(f"{entry}: {ln.strip().removeprefix('ptxas info    : ')}")
    return notes


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main():
    import torch

    if sys.argv[1:2] == ["--dist-worker"]:  # a rank of dist_ba_phase, on the device it names
        return dist_worker(*sys.argv[2:9])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    from mpsfm_tpu_torch import convert, kernels
    from mpsfm_tpu_torch.ba import cholesky
    from mpsfm_tpu_torch.ba.covariance import point_covariances
    from mpsfm_tpu_torch.extraction.matchers import attention
    from mpsfm_tpu_torch.integration import bini_diag, bini_fused

    dev = torch.device("cuda:0")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_s = kernels.build_all(kernels.all_kernels())
    print(f"kernel build: {build_s:.1f} s (nvcc, sm_90a, one process per source, in parallel)")
    for k in kernels.all_kernels():  # ptxas: registers, shared memory and spills of each kernel
        for ln in k.build_log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"  {k.name}: {ln.strip()}")
    print("K4 float32 (csrc/attention.cu) ptxas, hd 64 (attention_tile_kernel), hd 16 and 48 (attention_row_kernel): "
          + " | ".join(ptxas_notes(attention.KERNEL.build_log)))

    t = time.perf_counter()
    inputs = make_inputs(**FULL)
    print(f"inputs: {time.perf_counter() - t:.1f} s")
    k1 = k1_phase(dev, np.random.default_rng(SEED))
    k1_many = k1_many_phase(dev, np.random.default_rng(SEED + 1))
    k2 = k2_phase(dev, inputs)
    k3 = k3_phase(dev, inputs, point_covariances(convert.ba_data(inputs.ba, device=dev)))

    t = time.perf_counter()
    run_slice(inputs, dev)  # warm-up: the first call of each torch op loads its CUDA module
    print(f"main path warm-up: {time.perf_counter() - t:.3f} s wall")
    phases = {}
    counted = {"cholesky": cholesky.KERNEL, "cholesky_grid": cholesky.KERNEL_GRID, "cholesky_many": cholesky.KERNEL_MANY,
               "bini": bini_fused.KERNEL, "bini_diag": bini_diag.KERNEL}
    for k in counted.values():
        k.launches = 0
    t = time.perf_counter()
    out = run_slice(inputs, dev, phases=phases)
    wall = time.perf_counter() - t
    launches = {name: k.launches for name, k in counted.items()}
    quality = check_slice(out, inputs)
    print(f"main path: {wall:.3f} s wall; phases (s) {json.dumps({k: round(v, 4) for k, v in phases.items()})}")
    print(f"main path: cost0 {out['cost0']:.6g} -> cost {out['cost']:.6g}, {out['accepted']} accepted, "
          f"{int((out['d_w'] > 0).sum())} depth rows with weight, truncation {float(out['trunc']):.4g}, "
          f"mean |z - z_gt| {quality['depth_err']:.4g} (prior {quality['prior_err']:.4g}); "
          f"covariance depth-variance vs depth correlation {quality['cov_depth_corr']:.3f}; diag(H^-1) "
          f"{float(out['varlog'].min()):.3e} .. {float(out['varlog'].max()):.3e}, median new/old keypoint "
          f"variance {quality['var_ratio']:.4f}; launches {launches}")
    print(f"main path depth consistency: {phases['dc'] * 1e3:.2f} ms wall for {len(out['dc_scores'])} queries x "
          f"{out['dc_counts'].shape[1]} refs; scores {[round(x, 4) for x in out['dc_scores']]}; {quality['dc_line']}")
    if unlaunched(launches):
        raise AssertionError(f"kernels {unlaunched(launches)} were not launched on the main path")
    if launches["bini_diag"] != 1:  # all 8 × 2048 right-hand sides in one launch
        raise AssertionError(f"K3 made {launches['bini_diag']} launches on the main path, not 1")

    small_reference(dev)
    dc_phase(dev, inputs.bundle, *inputs.priors.z_gt.shape[1:])
    estimators_phase(dev, inputs.bundle, np.random.default_rng(SEED + 2))
    scene_phase(dev, inputs.bundle, out, np.random.default_rng(SEED + 4))
    _, scene_launches = scene_refinement_phase(dev, inputs.bundle, counted)
    scene_refinement_card_vs_cpu(dev)
    _, mapping_launches = mapping_phase(dev, counted)
    mapping_card_vs_cpu(dev)
    _, pipeline_launches = pipeline_phase(dev, counted)
    pipeline_card_vs_cpu(dev)
    _, dense_launches, dense_k1 = dense_modes_phase(dev, counted)
    print(f"neural extraction phase on {card_line()}")
    neural, neural_launches, k4 = neural_phase(dev, {**counted, "attention": attention.KERNEL,
                                                     "attention_tc": attention.KERNEL_TC})
    neural_k4_f32_launches = neural["full"]["k4_launches"]["float32"]["attention"]
    print(f"paper nets phase on {card_line()}")
    paper, paper_launches, gp_k1 = paper_nets_phase(dev, {**counted, "attention": attention.KERNEL,
                                                          "attention_tc": attention.KERNEL_TC})
    print(f"two-view nets phase on {card_line()}")
    _, two_view_launches, mast3r_k4 = two_view_phase(dev, {**counted, "attention": attention.KERNEL,
                                                                 "attention_tc": attention.KERNEL_TC})
    print(f"prior nets phase on {card_line()}")
    _, prior_launches, prior_k4 = prior_nets_phase(dev, {**counted, "attention": attention.KERNEL,
                                                         "attention_tc": attention.KERNEL_TC})
    sparse, sparse_launches = sparse_ba_phase(dev, counted)
    dist_k1, dist_k1_launches, dist_mapper_launches = dist_ba_phase(dev)
    if "--profile" in sys.argv[1:]:
        profile_slice(inputs, dev)

    rows = []
    main_k1 = "cholesky_grid" if cholesky.route(6 * FULL["n_cams"]) == "grid" else "cholesky"  # the main path's K
    grid = sparse["dense_schur_grid"]
    for name, route_src, replaces, k, n in (
        (f"cholesky_solve ({main_k1})", "mpsfm_tpu_torch/csrc/cholesky.cu", "mpsfm_tpu/ba/pallas_cholesky.py:25",
         k1, launches[main_k1]),
        # K1's grid route (chol_grid_kernel) in situ: the dense-Schur route at SPARSE_GRID_ROUTE, its launches and K
        ("cholesky_solve (cholesky_grid, dense-Schur route at 192 cameras)", "mpsfm_tpu_torch/csrc/cholesky.cu",
         "mpsfm_tpu/ba/pallas_cholesky.py:25", grid["k1"], grid["launches"]["cholesky_grid"]),
        # K1's factorization with many right-hand sides: on the JAX path XLA's cho_factor + cho_solve
        ("cholesky_solve_many", "mpsfm_tpu_torch/csrc/cholesky_many.cu", "mpsfm_tpu/ba/covariance.py:91",
         k1_many, launches["cholesky_many"]),
        ("bini_pcg", "mpsfm_tpu_torch/csrc/bini.cu", "mpsfm_tpu/integration/bini_pallas.py:83",
         k2, launches["bini"]),
        # no TPU kernel: on the JAX path _diag_inverse_at_impl runs as XLA ops
        ("bini_diag_pcg", "mpsfm_tpu_torch/csrc/bini_diag.cu", "mpsfm_tpu/integration/bini.py:592",
         k3, launches["bini_diag"]),
        # K1 at the dense modes phase's last global BA: that phase's launches and shape
        ("cholesky_solve (dense modes phase)", "mpsfm_tpu_torch/csrc/cholesky.cu",
         "mpsfm_tpu/ba/pallas_cholesky.py:25", dense_k1, dense_launches["cholesky"]),
        # K1 on the distributed BA's dense-T route (rank 0 of two): its own path's launches and shape
        ("cholesky_solve (sharded dense-T route)", "mpsfm_tpu_torch/csrc/cholesky.cu",
         "mpsfm_tpu/ba/pallas_cholesky.py:25", dist_k1, dist_k1_launches),
    ):
        bound = max(k["ops_ms"], k["bytes_ms"])
        rows.append(dict(
            name=name, route="cuda", source=route_src, replaces=replaces, launches=n,
            max_abs_err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=bound,
            bound_by="operations" if k["ops_ms"] >= k["bytes_ms"] else "bytes", library_ms=k["library_ms"],
        ))
        print(f"{name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms, library {k['library_ms']}, "
              f"bound {bound:.5f} ms), {n} launches on the main path")
    # K4 at the neural phase's largest bucket, its first self-attention call: the tensor-core kernel (bfloat16)
    # with its launches in the pipeline run (d), whose LightGlue is bfloat16; the float32 kernel with its launches
    # in (a)'s float32 LightGlue run, the one path of the phase that reaches it
    big = max(b for _, b, _ in k4)
    for dt, name, src, launched in (
        ("bfloat16", "lightglue_attention_tc", "attention_tc.cu", neural_launches["attention_tc"]),
        ("float32", "lightglue_attention_f32", "attention.cu", neural_k4_f32_launches),
    ):
        k = k4[("self", big, dt)]
        bound = max(k["ops_ms"], k["bytes_ms"])
        rows.append(dict(
            name=f"{name} (bucket {big})", route="cuda", source=f"mpsfm_tpu_torch/csrc/{src}",
            replaces="mpsfm_tpu/extraction/matchers/lightglue.py:322", launches=launched,
            max_abs_err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=bound,
            bound_by="operations" if k["ops_ms"] >= k["bytes_ms"] else "bytes", library_ms=k["library_ms"]))
        print(f"K4 {dt} at bucket {big}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {bound:.5f} ms), {launched} launches"
              + (" in the neural pipeline run" if dt == "bfloat16" else " in the float32 LightGlue run of (a)"))
    # K1 many at the RoMa GP's K_bb (the JAX package's jnp.linalg.solve, XLA's LU): its launches by the GP in the
    # paper phase's sp-roma-dense_m3dv2 run
    gp_launches = paper["pipelines"]["sp-roma-dense_m3dv2"]["gp_launches"]
    bound = max(gp_k1["ops_ms"], gp_k1["bytes_ms"])
    rows.append(dict(
        name=f"cholesky_solve_many (RoMa GP, K = {paper['full']['gp_K']}, N = {paper['full']['gp_N']})", route="cuda",
        source="mpsfm_tpu_torch/csrc/cholesky_many.cu", replaces="mpsfm_tpu/extraction/nets/roma.py:342",
        launches=gp_launches, max_abs_err=gp_k1["err"], ms=gp_k1["ms"], plain_ms=gp_k1["plain_ms"], bound_ms=bound,
        bound_by="operations" if gp_k1["ops_ms"] >= gp_k1["bytes_ms"] else "bytes", library_ms=gp_k1["library_ms"]))
    print(f"K1 many at the RoMa GP: {gp_k1['ms']:.4f} ms (plain {gp_k1['plain_ms']:.3f} ms, library "
          f"{gp_k1['library_ms']:.4f} ms, torch.linalg.solve {gp_k1['lu_ms']:.4f} ms, bound {bound:.5f} ms), "
          f"{gp_launches} launches by the GP in the sp-roma-dense_m3dv2 run")
    # K4 float32 at MASt3R's encoder shape (both views batched, 2x1200x16x64) and at its decoder cross-attention
    # (1x1200x12x64): its launches in the phase's sp-mast3r run, every MASt3R attention on it (MAST3R_K4 a forward);
    # at DepthAnythingV2-vitl's (1x1814x16x64): its launches in the sp-lg_dav2 run (the depth net's only); at RoMa's
    # DINOv2's (2x2305x16x64): its launches in the paper phase's sp-roma-dense_m3dv2 run (24 a RoMa forward)
    k4_f32 = [(f"mast3r_attention_f32 ({shape})", k, "sp-mast3r", two_view_launches["sp-mast3r"]["attention"])
              for shape, k in mast3r_k4.items() if shape != "da2_vitl"]
    k4_f32 += [("depth_anything_v2_attention_f32 (1x1814x16x64)", mast3r_k4["da2_vitl"], "sp-lg_dav2",
                two_view_launches["sp-lg_dav2"]["attention"]),
               ("roma_dinov2_attention_f32 (2x2305x16x64)", paper["k4"], "sp-roma-dense_m3dv2",
                paper_launches["sp-roma-dense_m3dv2"]["attention"])]
    # K4 float32 at DepthPro's patch encoder (35 patches x 730 tokens x 16 heads of 64): its launches in the prior
    # nets phase's sp-lg_depthpro run (DEPTHPRO_K4 a forward); at the trained prior's (heads of 48, on
    # attention_row_kernel<48>): its launches in fit_scene_prior's run (depth_blocks a step)
    for key, run in (("depthpro", "sp-lg_depthpro"), ("hd48", "fit_scene_prior")):
        k = prior_k4[key]
        name = "depth_pro_attention_f32" if key == "depthpro" else "mono_attention_f32_hd48"
        k4_f32.append((f"{name} ({k['shape']})", k, run, prior_launches[run]["attention"]))
    for name, k, run, launched in k4_f32:
        bound = max(k["ops_ms"], k["bytes_ms"])
        rows.append(dict(
            name=name, route="cuda", source="mpsfm_tpu_torch/csrc/attention.cu",
            replaces="mpsfm_tpu/extraction/matchers/lightglue.py:322", launches=launched,
            max_abs_err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=bound,
            bound_by="operations" if k["ops_ms"] >= k["bytes_ms"] else "bytes", library_ms=k["library_ms"]))
        print(f"K4 float32 {name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms, SDPA float32 "
              f"{k['library_ms']:.4f} ms, bound {bound:.5f} ms), {launched} launches in the {run} run")
    print(f"scene refinement launches: {json.dumps(scene_launches)}")
    print(f"mapping launches: {json.dumps(mapping_launches)}")
    print(f"pipeline launches: {json.dumps(pipeline_launches)}")
    print(f"dense modes launches: {json.dumps(dense_launches)}")
    print(f"neural extraction launches: {json.dumps(neural_launches)}")
    print(f"paper nets launches: {json.dumps(paper_launches)}")
    print(f"two-view nets launches: {json.dumps(two_view_launches)}")
    print(f"prior nets launches: {json.dumps(prior_launches)}")
    print(f"sparse BA launches: {json.dumps(sparse_launches)}")
    print(f"distributed BA launches: K1 {dist_k1_launches} on the dense-T route; the mapper on rank 0 "
          f"{json.dumps(dist_mapper_launches)}")
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""mpsfm_tpu_torch — the PyTorch/CUDA port of mpsfm_tpu for one NVIDIA H100.

The JAX package `mpsfm_tpu` stays the reference; this package is ported
beside it slice by slice and never imports it (nor jax). So far: the
mapper's refinement step with its uncertainty chain — point covariances,
BiNI gate + IRLS/PCG solve, diag(H⁻¹) at the keypoints and the updated
depth variances, the depth-consistency check's device core, device-side
depth rows, dense and sparse LM-Schur bundle adjustment — driven from the
scene (the Reconstruction, per-image priors, the BA problem and the
Optimizer), the geometry and robust estimators, and the mapper's
control loop over them (MpsfmMapper: registration, triangulation,
next-view selection, the depth-consistency checker), which maps a scene;
and the main path from images (pipeline.reconstruct, cli), which maps an
RGB-D directory; with several ranks of a process group (one process a
card) the large global BAs are sharded over them.

Layout (each module mirrors its counterpart in mpsfm_tpu/):
  geometry/rotations.py     quaternion / SE(3) math
  geometry/linalg.py        small-matrix nullspaces, 3×3 SVD, chunked eigh
  geometry/projection.py    Camera, projection and lifting
  geometry/triangulation.py two- and n-view DLT, angles, depths
  estimators/               essential, homography and PnP solvers, their
                            fixed-budget RANSAC (samples given), two-view
                            geometry and classification
  mapper/depth_consistency.py  z-buffered cross-projection, whitened
                            counts of a query against B refs, bundle score,
                            the checker with its relaxation ladder
  ba/losses.py              robust losses
  ba/cholesky.py            reduced-camera Cholesky solve, one or many
                            right-hand sides (CUDA kernels K1)
  ba/covariance.py          Schur point covariances
  ba/dense.py               dense (C,P) LM-Schur BA
  ba/solver.py              slot-table LM (solve_ba): dense-Schur (K1),
                            block-sparse Schur CG or matrix-free PCG
  ba/schur_sparse.py        the explicit block-sparse Schur complement of
                            bundles above the dense layout
  ba/device_depth.py        depth observation rows sampled on the device
  integration/bini.py       BiNI energy, IRLS, anchor transport, diag(H⁻¹),
                            builders
  integration/bini_fused.py BiNI PCG core + fixed-budget solve (CUDA kernel K2)
  integration/bini_diag.py  deflated PCG of diag(H⁻¹) (CUDA kernel K3)
  ba/problem.py             the BA problem from the Reconstruction (host
                            passes, padded BAData / DenseBAData tensors)
  ba/shift_scale.py         prior shift/scale, truncation multiplier (host)
  mapper/optimizer.py       the Optimizer (ba, ba_fused, refine_3d_points,
                            point covariances), dense and sparse paths
  mapper/registration.py    init pair and next image (RANSACs on the device)
  mapper/triangulator.py, image_selection.py
                            track building and next-view ranking (host numpy)
  mapper/mapper.py          MpsfmMapper, the incremental mapping loop
  scene/reconstruction.py, corrgraph.py, correspondences.py
                            the scene's host state, verification
  scene/priors.py           Depth and Normals priors (host numpy)
  scene/image_priors.py     ImagePriors and the bundle-level functions of the
                            integration and the int_covs chain
  datasets/simple.py        SimpleParser: images/, depth/, intrinsics.yaml
  extraction/               pairs, classical features, mutual-NN matches,
                            measured priors, the Extraction facade
  utils/io.py, colmap_io.py PNG decoder, HDF5 / directory artifact stores,
                            COLMAP text and binary models
  pipeline.py, cli.py, eval.py
                            reconstruct from a directory, its command line, ATE
  kernels.py                nvcc build + ctypes loader for csrc/*.cu
  parallel/                 the distributed BA (points sharded over the
                            ranks of a torch.distributed group), process
                            groups, sharded batched inference
  convert.py                JAX-package state (numpy) -> port tensors:
                            BA data, BiNI inputs, cameras, poses, DC
                            inputs, the Reconstruction, ImagePriors,
                            Correspondences, a distributed BA's partition

Precision policy: everything is float32 with TF32 off for matmuls and
cuDNN, the counterpart of the JAX package's forced "highest" matmul
precision (mpsfm_tpu/__init__.py).
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device="cuda") -> torch.device:
    """The device that state-creating entry points put their tensors on.
    A CUDA device with no GPU present raises: nothing silently moves to
    the CPU. Callers that want the CPU ask for it with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mpsfm_tpu_torch: no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev

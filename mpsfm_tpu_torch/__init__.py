"""mpsfm_tpu_torch — the PyTorch/CUDA port of mpsfm_tpu for one NVIDIA H100.

The JAX package `mpsfm_tpu` stays the reference; this package is ported
beside it slice by slice and never imports it (nor jax). So far: the
mapper's refinement step with its uncertainty chain — point covariances,
BiNI gate + IRLS/PCG solve, diag(H⁻¹) at the keypoints and the updated
depth variances, device-side depth rows, dense LM-Schur bundle adjustment.

Layout (each module mirrors its counterpart in mpsfm_tpu/):
  geometry/rotations.py     quaternion / SE(3) math
  ba/losses.py, solver.py   robust losses, BAData + assembly, LM helpers
  ba/cholesky.py            reduced-camera Cholesky solve, one or many
                            right-hand sides (CUDA kernels K1)
  ba/covariance.py          Schur point covariances
  ba/dense.py               dense (C,P) LM-Schur BA
  ba/device_depth.py        depth observation rows sampled on the device
  integration/bini.py       BiNI energy, IRLS, anchor transport, diag(H⁻¹),
                            builders
  integration/bini_fused.py BiNI PCG core + fixed-budget solve (CUDA kernel K2)
  integration/bini_diag.py  deflated PCG of diag(H⁻¹) (CUDA kernel K3)
  scene/image_priors.py     the updated keypoint depth variances
  kernels.py                nvcc build + ctypes loader for csrc/*.cu
  convert.py                JAX-package state (numpy) -> port tensors

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

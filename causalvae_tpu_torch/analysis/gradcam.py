"""Grad-CAM over the residual classifier (A3) (``causalvae_tpu/analysis/gradcam.py``).

The class score's gradient with respect to the second conv's features, by
``torch.autograd.grad`` through the ``SimpleClassifier`` split at ``conv1``:
the stem (conv0 -> max-pool -> ReLU -> conv1) to the target features, the
head (max-pool -> ReLU -> fc1 -> ReLU -> fc2 -> log-softmax) from them. The
map is upsampled with ``F.interpolate(mode="bilinear",
align_corners=False)``, which equals JAX's ``jax.image.resize(...,
"bilinear")`` on an upscale (``tests/test_torch_analysis.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from causalvae_tpu_torch.device import module_device


def _split_forward(model):
    """(stem to conv1's features, head from those features), NCHW inside."""

    def features(x):
        h = F.relu(F.max_pool2d(model.conv0(x.permute(0, 3, 1, 2)), 2))
        return model.conv1(h)  # the target layer

    def head(feats):
        h = F.relu(F.max_pool2d(feats, 2))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # JAX's NHWC flatten
        return F.log_softmax(model.fc2(F.relu(model.fc1(h))), dim=-1)

    return features, head


def grad_cam(model, x, class_idx) -> np.ndarray:
    """GAP-weighted CAM at the second conv layer of NHWC ``x``, upsampled to
    the input size: (B, H, W) maps, each normalized to [0, 1]."""
    dev = module_device(model)
    x = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x).to(dev)
    class_idx = torch.as_tensor(np.asarray(class_idx) if not torch.is_tensor(class_idx)
                                else class_idx).to(dev).long()
    features, head = _split_forward(model)
    with torch.enable_grad():
        feats = features(x).detach().requires_grad_()
        score = head(feats).gather(1, class_idx[:, None]).sum()
        grads, = torch.autograd.grad(score, feats)
    with torch.no_grad():
        weights = grads.mean(dim=(2, 3), keepdim=True)  # GAP over space
        cam = F.relu((weights * feats).sum(dim=1))  # (B, h, w)
        cam = F.interpolate(cam[:, None], size=tuple(x.shape[1:3]), mode="bilinear",
                            align_corners=False)[:, 0]
        lo = cam.amin(dim=(1, 2), keepdim=True)
        hi = cam.amax(dim=(1, 2), keepdim=True)
        cam = (cam - lo) / torch.where(hi - lo > 0, hi - lo, torch.ones_like(hi))
    return cam.cpu().numpy()


def per_class_mean_cam(model, x: np.ndarray, labels: np.ndarray,
                       n_classes: int = 10) -> np.ndarray:
    """Mean CAM per class over a corpus -> (n_classes, H, W); a class with
    no image keeps zeros."""
    cams = grad_cam(model, x, labels)
    out = np.zeros((n_classes,) + cams.shape[1:], np.float32)
    for c in range(n_classes):
        sel = labels == c
        if sel.any():
            out[c] = cams[sel].mean(axis=0)
    return out

"""Small CNN classifier used for evaluation (paper §5 metrics 1 and 2),
in PyTorch (port of ``repro.models.classifier``).

Trained (a) on real data to act as the dataset-specific scoring network
(IS-style score and FID features), and (b) on generated samples to
compute the classification metrics against a real test set.

One network, no client axis: conv kernels are ``[O, I, kh, kw]``, dense
weights ``[in, out]`` (``repro_torch.bridge.classifier_from_numpy``
converts the reference's HWIO kernels). Images are NHWC in [-1, 1].
The convolutions pad as XLA's "SAME" does, which at stride 2 on 28x28
and 14x14 puts the odd pixel after: (0, 1).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.huscf import value_and_grad
from repro_torch.models import nn
from repro_torch.optim.optimizers import adam
from repro_torch.tree import tree_map

_INFER_BATCH = 512


def init_cnn(gen: torch.Generator, num_classes: int = 10, device="cuda"
             ) -> Dict:
    """Weights drawn on the CPU from ``gen``, then moved to ``device``."""
    device = resolve_device(device)
    one = lambda p: tree_map(lambda x: x[0], p)   # noqa: E731
    return {"c1": one(nn.conv2d_init(1, 1, 32, 3, gen, device)),
            "c2": one(nn.conv2d_init(1, 32, 64, 3, gen, device)),
            "fc1": nn.linear_init(7 * 7 * 64, 128, gen, device),
            "fc2": nn.linear_init(128, num_classes, gen, device)}


def _conv_same(p: Dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """NCHW conv with XLA's SAME padding."""
    kh, kw = p["w"].shape[2:]
    ph = nn.same_pads(x.shape[2], kh, stride)
    pw = nn.same_pads(x.shape[3], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, p["w"], p["b"], stride=stride)


def cnn_apply(params: Dict, x: torch.Tensor, return_features: bool = False):
    """x [N, 28, 28, 1] -> logits [N, C] (and the 128 penultimate
    features)."""
    h = torch.relu(_conv_same(params["c1"], x.permute(0, 3, 1, 2), 2))
    h = torch.relu(_conv_same(params["c2"], h, 2))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # H-W-C order
    feat = torch.relu(nn.linear_apply(params["fc1"], h))
    logits = nn.linear_apply(params["fc2"], feat)
    if return_features:
        return logits, feat
    return logits


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, -1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def _device_of(params: Dict) -> torch.device:
    return params["fc2"]["w"].device


def train_classifier(gen: torch.Generator, images: np.ndarray,
                     labels: np.ndarray, *, epochs: int = 3,
                     batch: int = 128, lr: float = 1e-3,
                     num_classes: int = 10, device="cuda",
                     params: Optional[Dict] = None) -> Dict:
    """Train the CNN with Adam; returns params. images in [-1, 1]
    [N, H, W, 1]. The batch order is the reference's
    (``default_rng(0)`` permutations); ``params`` starts from given
    weights on their device instead of drawing from ``gen``."""
    if params is None:
        params = init_cnn(gen, num_classes, device)
    dev = _device_of(params)
    opt_init, opt_update = adam(lr)
    opt_state = opt_init(params)
    x_all = torch.as_tensor(np.asarray(images, np.float32), device=dev)
    y_all = torch.as_tensor(np.asarray(labels), device=dev)
    rng = np.random.default_rng(0)
    n = images.shape[0]
    for _ in range(epochs):
        order = rng.permutation(n)
        for b in range(max(1, n // batch)):
            sel = order[b * batch:(b + 1) * batch]
            if sel.size == 0:
                continue
            idx = torch.as_tensor(sel, device=dev)
            _, _, grads = value_and_grad(
                lambda p: (xent(cnn_apply(p, x_all[idx]), y_all[idx]), None),
                params)
            opt_state, params = opt_update(opt_state, grads, params)
    return params


def _batched(params: Dict, images: np.ndarray, fn, batch: int
             ) -> np.ndarray:
    dev = _device_of(params)
    outs = []
    with torch.no_grad():
        for b in range(0, images.shape[0], batch):
            x = torch.as_tensor(np.asarray(images[b:b + batch], np.float32),
                                device=dev)
            outs.append(fn(x).cpu().numpy())
    return np.concatenate(outs)


def predict(params: Dict, images: np.ndarray, batch: int = _INFER_BATCH
            ) -> np.ndarray:
    return _batched(params, images,
                    lambda x: torch.argmax(cnn_apply(params, x), -1)
                    .to(torch.int32), batch)


def predict_proba(params: Dict, images: np.ndarray,
                  batch: int = _INFER_BATCH) -> np.ndarray:
    return _batched(params, images,
                    lambda x: torch.softmax(cnn_apply(params, x), -1), batch)


def features(params: Dict, images: np.ndarray, batch: int = _INFER_BATCH
             ) -> np.ndarray:
    return _batched(params, images,
                    lambda x: cnn_apply(params, x, return_features=True)[1],
                    batch)

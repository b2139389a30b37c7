"""Conditional GAN of paper Table 3 as a layered model (port of
``repro.models.gan``).

Generator  (z in R^100, label in R^10 -> 28x28 image):
  L0: label embed + concat, FC -> 256*7*7, BN, ReLU
  L1: ConvT 256->128 4x4 s2, BN, ReLU          (7 -> 14)
  L2: ConvT 128->128 3x3 s1, BN, ReLU          (14 -> 14)   <- middle
  L3: ConvT 128->64  4x4 s2, BN, ReLU          (14 -> 28)
  L4: ConvT 64->1    3x3 s1, Tanh              (28 -> 28)

Discriminator (image 28x28 + label channel -> logit):
  L0: label embed -> 28x28 channel, concat; Conv 2->64 4x4 s2, BN, LReLU
  L1: Conv 64->128  4x4 s2, BN, LReLU                    (14->7)
  L2: Conv 128->128 3x3 s1, BN, LReLU                    (7->7) <- middle
  L3: Conv 128->256 4x4 s2, BN, LReLU                    (7->4)
  L4: Flatten, FC->1

Every layer is a ``LayerDef(init, apply)``. ``init(n, gen, device,
dtype=torch.float32)`` draws ``n`` independent copies stacked on a
leading axis;
``apply(p, x, train, reduce=None) -> (y, new_p)`` takes params with a
leading client axis ``K`` and activations ``[K, b, ...]`` (NHWC; a
convolution's are stored client-minor, ``models.nn``'s "Layouts"), so a
profile group's stacked clients run as one call (the reference's
``vmap``). Server layers run with ``K = 1`` (see ``core.segments``);
``reduce`` is their BatchNorm statistics' sum over the ranks of a
client-sharded step (``nn.batchnorm_apply``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Sequence

import torch

from repro_torch.models import nn

Z_DIM = 100
NUM_CLASSES = 10
IMG = 28

GEN_LAYERS = 5
DISC_LAYERS = 5
GEN_MIDDLE = GEN_LAYERS // 2
DISC_MIDDLE = DISC_LAYERS // 2
# flattened per-sample D middle activation (L2 output 7x7x128, H-W-C
# order) — the feature width of the clustering EMA
DISC_MIDDLE_FEATURES = 7 * 7 * 128


class LayerDef(NamedTuple):
    init: Callable
    apply: Callable


# ---------------------------------------------------------------------------
# generator layers
# ---------------------------------------------------------------------------

def _g0_init(n, gen, device, dtype=torch.float32):
    return {"embed": nn.embedding_init(n, NUM_CLASSES, NUM_CLASSES, gen,
                                       device, dtype=dtype),
            "fc": nn.dense_init(n, Z_DIM + NUM_CLASSES, 256 * 7 * 7, gen,
                                device, dtype=dtype),
            "bn": nn.batchnorm_init(n, 256, device, dtype)}


def _g0_apply(p, x, train, reduce=None):
    z, y = x                                   # z [K, b, Z], y [K, b]
    e = nn.embedding_apply(p["embed"], y)
    h = torch.cat([z, e.to(z.dtype)], -1)
    h = nn.dense_apply(p["fc"], h)
    h = h.reshape(h.shape[0], h.shape[1], 7, 7, 256)
    h, bn = nn.batchnorm_apply(p["bn"], h, train=train, reduce=reduce)
    return torch.relu(h), {**p, "bn": bn}


def _gconvt_init(cin, cout, k):
    def init(n, gen, device, dtype=torch.float32):
        return {"convt": nn.convT2d_init(n, cin, cout, k, gen, device,
                                         dtype=dtype),
                "bn": nn.batchnorm_init(n, cout, device, dtype)}
    return init


def _gconvt_apply(stride, final=False):
    def apply(p, x, train, reduce=None):
        h = nn.convT2d_apply(p["convt"], x, stride=stride)
        if final:
            return torch.tanh(h), p
        h, bn = nn.batchnorm_apply(p["bn"], h, train=train, reduce=reduce)
        return torch.relu(h), {**p, "bn": bn}
    return apply


def _g4_init(n, gen, device, dtype=torch.float32):
    return {"convt": nn.convT2d_init(n, 64, 1, 3, gen, device, dtype=dtype)}


GEN_LAYER_DEFS: List[LayerDef] = [
    LayerDef(_g0_init, _g0_apply),
    LayerDef(_gconvt_init(256, 128, 4), _gconvt_apply(2)),
    LayerDef(_gconvt_init(128, 128, 3), _gconvt_apply(1)),
    LayerDef(_gconvt_init(128, 64, 4), _gconvt_apply(2)),
    LayerDef(_g4_init, _gconvt_apply(1, final=True)),
]


# ---------------------------------------------------------------------------
# discriminator layers
# ---------------------------------------------------------------------------

def _d0_init(n, gen, device, dtype=torch.float32):
    return {"embed": nn.embedding_init(n, NUM_CLASSES, IMG * IMG, gen,
                                       device, dtype=dtype),
            "conv": nn.conv2d_init(n, 2, 64, 4, gen, device, dtype=dtype),
            "bn": nn.batchnorm_init(n, 64, device, dtype)}


def _d0_apply(p, x, train, reduce=None):
    img, y = x                                 # img [K, b, 28, 28, 1]
    e = nn.embedding_apply(p["embed"], y)
    e = e.reshape(e.shape[0], e.shape[1], IMG, IMG, 1)
    h = nn.channel_cat([img, e.to(img.dtype)])  # client-minor, for the conv
    h = nn.conv2d_apply(p["conv"], h, stride=2)
    h, bn = nn.batchnorm_apply(p["bn"], h, train=train, reduce=reduce)
    return nn.leaky_relu(h), {**p, "bn": bn}


def _dconv_init(cin, cout, k):
    def init(n, gen, device, dtype=torch.float32):
        return {"conv": nn.conv2d_init(n, cin, cout, k, gen, device,
                                       dtype=dtype),
                "bn": nn.batchnorm_init(n, cout, device, dtype)}
    return init


def _dconv_apply(stride):
    def apply(p, x, train, reduce=None):
        h = nn.conv2d_apply(p["conv"], x, stride=stride)
        h, bn = nn.batchnorm_apply(p["bn"], h, train=train, reduce=reduce)
        return nn.leaky_relu(h), {**p, "bn": bn}
    return apply


def _d4_init(n, gen, device, dtype=torch.float32):
    return {"fc": nn.dense_init(n, 4 * 4 * 256, 1, gen, device, dtype=dtype)}


def _d4_apply(p, x, train, reduce=None):
    h = x.reshape(x.shape[0], x.shape[1], -1)   # NHWC flatten, H-W-C order
    return nn.dense_apply(p["fc"], h)[..., 0], p


DISC_LAYER_DEFS: List[LayerDef] = [
    LayerDef(_d0_init, _d0_apply),
    LayerDef(_dconv_init(64, 128, 4), _dconv_apply(2)),
    LayerDef(_dconv_init(128, 128, 3), _dconv_apply(1)),
    LayerDef(_dconv_init(128, 256, 4), _dconv_apply(2)),
    LayerDef(_d4_init, _d4_apply),
]

NET_LAYER_DEFS = {"G": GEN_LAYER_DEFS, "D": DISC_LAYER_DEFS}


# ---------------------------------------------------------------------------
# whole networks: ``n`` stacked copies (a single network is n = 1)
# ---------------------------------------------------------------------------

def init_generator(gen: torch.Generator, device, n: int = 1,
                   dtype=torch.float32) -> List[Dict]:
    """Parameters as ``dtype`` (BatchNorm's running statistics stay
    float32, as in the reference)."""
    return [d.init(n, gen, device, dtype) for d in GEN_LAYER_DEFS]


def init_discriminator(gen: torch.Generator, device, n: int = 1,
                       dtype=torch.float32) -> List[Dict]:
    return [d.init(n, gen, device, dtype) for d in DISC_LAYER_DEFS]


def run_layers(defs: Sequence[LayerDef], params: List[Dict], x, *,
               start: int, stop: int, train: bool):
    """Run layers [start, stop); returns (activations, new_params_list)."""
    new_params = list(params)
    for i in range(start, stop):
        x, new_params[i] = defs[i].apply(params[i], x, train)
    return x, new_params


def generator_forward(params: List[Dict], z: torch.Tensor, y: torch.Tensor,
                      *, train: bool):
    """z [K, b, Z_DIM], y [K, b] -> images [K, b, 28, 28, 1]."""
    return run_layers(GEN_LAYER_DEFS, params, (z, y), start=0,
                      stop=GEN_LAYERS, train=train)


def discriminator_forward(params: List[Dict], img: torch.Tensor,
                          y: torch.Tensor, *, train: bool):
    """img [K, b, 28, 28, 1], y [K, b] -> logits [K, b]."""
    return run_layers(DISC_LAYER_DEFS, params, (img, y), start=0,
                      stop=DISC_LAYERS, train=train)


# ---------------------------------------------------------------------------
# per-layer cost model (FLOPs forward, activation bytes out) for Eq. 3-6
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerCost:
    flops_fwd: float      # per-sample forward FLOPs
    act_bytes: float      # per-sample activation bytes at layer OUTPUT
    params: int

    @property
    def flops_bwd(self) -> float:
        return 2.0 * self.flops_fwd  # standard backward ~ 2x forward


def _conv_cost(h, w, cin, cout, k):
    return 2.0 * h * w * cin * cout * k * k


GEN_LAYER_COSTS: List[LayerCost] = [
    LayerCost(2.0 * (Z_DIM + NUM_CLASSES) * 256 * 49, 7 * 7 * 256 * 4, (Z_DIM + NUM_CLASSES) * 256 * 49 + 256 * 49 + 100),
    LayerCost(_conv_cost(14, 14, 256, 128, 4), 14 * 14 * 128 * 4, 256 * 128 * 16 + 128),
    LayerCost(_conv_cost(14, 14, 128, 128, 3), 14 * 14 * 128 * 4, 128 * 128 * 9 + 128),
    LayerCost(_conv_cost(28, 28, 128, 64, 4), 28 * 28 * 64 * 4, 128 * 64 * 16 + 64),
    LayerCost(_conv_cost(28, 28, 64, 1, 3), 28 * 28 * 1 * 4, 64 * 9 + 1),
]

DISC_LAYER_COSTS: List[LayerCost] = [
    LayerCost(_conv_cost(14, 14, 2, 64, 4), 14 * 14 * 64 * 4, 2 * 64 * 16 + 64 + 10 * 784),
    LayerCost(_conv_cost(7, 7, 64, 128, 4), 7 * 7 * 128 * 4, 64 * 128 * 16 + 128),
    LayerCost(_conv_cost(7, 7, 128, 128, 3), 7 * 7 * 128 * 4, 128 * 128 * 9 + 128),
    LayerCost(_conv_cost(4, 4, 128, 256, 4), 4 * 4 * 256 * 4, 128 * 256 * 16 + 256),
    LayerCost(2.0 * 4 * 4 * 256 * 1, 1 * 4, 4 * 4 * 256 + 1),
]

NET_LAYER_COSTS = {"G": GEN_LAYER_COSTS, "D": DISC_LAYER_COSTS}


def gan_layer_costs():
    return GEN_LAYER_COSTS, DISC_LAYER_COSTS


# ---------------------------------------------------------------------------
# loss (non-saturating BCE on logits)
# ---------------------------------------------------------------------------

def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(torch.clamp_min(logits, 0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def d_loss_fn(d_logits_real: torch.Tensor, d_logits_fake: torch.Tensor
              ) -> torch.Tensor:
    return bce_logits(d_logits_real, 1.0) + bce_logits(d_logits_fake, 0.0)


def g_loss_fn(d_logits_fake: torch.Tensor) -> torch.Tensor:
    return bce_logits(d_logits_fake, 1.0)

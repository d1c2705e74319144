"""hloc's NetVLAD (VGG16 to relu5_3, a 64-cluster NetVLAD layer, a
32768 -> 4096 whitening, L2) as an `nn.Module`.

Counterpart of the JAX package's `loop/netvlad_hloc.py`. The module's
names follow hloc's (`backbone.{i}` in torchvision's VGG16 `features`
indices, `netvlad.score_proj`, `netvlad.centers`, `whiten`), so hloc's
Pitts30K state dict loads as it is (`HlocNetVLAD(checkpoint=path)`);
`from_jax_params` carries the JAX package's parameter tree across. The
input is RGB in [0, 255] minus the MatConvNet channel means the
checkpoint was trained with. The loop closure uses it only when
NETVLAD_CHECKPOINT names a checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

VGG16_WIDTHS = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                512, 512, 512, "M", 512, 512, 512]
RGB_MEAN = (123.68, 116.779, 103.939)
K = 64
CDIM = 512
WHITEN_DIM = 4096


class NetVLADLayer(nn.Module):
    def __init__(self, dim=CDIM, clusters=K):
        super().__init__()
        self.score_proj = nn.Conv1d(dim, clusters, kernel_size=1, bias=False)
        self.centers = nn.Parameter(torch.empty(dim, clusters))
        nn.init.xavier_uniform_(self.centers)

    def forward(self, x):
        """x [C, N] -> [C*K]: soft assignment, residual sums without an
        [N, K, C] intermediate, per-cluster then global L2 (hloc flattens
        [C, K] row-major)."""
        scores = torch.softmax(self.score_proj(x[None])[0], dim=0)   # [K, N]
        vlad = x @ scores.T - self.centers * scores.sum(dim=1)[None, :]
        vlad = vlad / torch.linalg.norm(vlad, dim=0,
                                        keepdim=True).clamp(min=1e-12)
        v = vlad.reshape(-1)
        return v / torch.linalg.norm(v).clamp(min=1e-12)


class HlocNetVLAD(nn.Module):
    """checkpoint: a path to hloc's NetVLAD state dict (or None for
    weights drawn from `seed`); whiten_dim: the whitening's output width
    (0: none). `extract_image` takes the SLAM's BGR uint8 frame."""

    def __init__(self, checkpoint=None, whiten_dim=WHITEN_DIM, seed=0,
                 device="cuda"):
        super().__init__()
        layers, cin = [], 3
        for w in VGG16_WIDTHS:
            if w == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, w, 3, padding=1), nn.ReLU()]
                cin = w
        self.backbone = nn.Sequential(*layers)
        self.netvlad = NetVLADLayer()
        self.whiten = nn.Linear(K * CDIM, whiten_dim) if whiten_dim else None
        if checkpoint is None:
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in self.parameters():     # He normal, zero biases
                    p.copy_(torch.randn(p.shape, generator=gen) *
                            (2.0 / p[0].numel()) ** 0.5 if p.ndim > 1
                            else torch.zeros_like(p))
        else:
            sd = torch.load(checkpoint, map_location="cpu",
                            weights_only=True)
            self.load_state_dict(sd.get("state_dict", sd))
        self.to(device).eval()

    @property
    def dim(self):
        return self.whiten.out_features if self.whiten is not None else \
            K * CDIM

    def forward(self, image_rgb):
        """image_rgb [H, W, 3] float 0..255 RGB -> [dim]."""
        mean = torch.tensor(RGB_MEAN, device=image_rgb.device)
        x = (image_rgb - mean).permute(2, 0, 1)[None]
        feats = self.backbone(x)[0]                  # [C, h, w]
        v = self.netvlad(feats.reshape(CDIM, -1))
        if self.whiten is not None:
            v = self.whiten(v)
            v = v / torch.linalg.norm(v).clamp(min=1e-12)
        return v

    def extract_image(self, image_bgr):
        """[H, W, 3] uint8 BGR -> numpy [dim] descriptor."""
        dev = next(self.parameters()).device
        img = torch.as_tensor(np.ascontiguousarray(image_bgr[..., ::-1]),
                              device=dev).float()
        with torch.no_grad():
            return self(img).cpu().numpy()


def from_jax_params(params, device="cpu"):
    """An HlocNetVLAD holding the JAX package's parameter tree (numpy
    leaves: conv{i} HWIO weights, score_proj [C, K], centers [C, K],
    whiten [K*C, D])."""
    whiten = params.get("whiten")
    net = HlocNetVLAD(whiten_dim=0 if whiten is None else
                      np.shape(whiten["w"])[1], device="cpu")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    sd = {}
    for i, m in enumerate(net.backbone):
        if isinstance(m, nn.Conv2d):
            p = params[f"conv{i}"]
            sd[f"backbone.{i}.weight"] = t(p["w"]).permute(3, 2, 0, 1)
            sd[f"backbone.{i}.bias"] = t(p["b"])
    sd["netvlad.score_proj.weight"] = t(params["score_proj"]["w"]).T[..., None]
    sd["netvlad.centers"] = t(params["centers"])
    if whiten is not None:
        sd["whiten.weight"] = t(whiten["w"]).T
        sd["whiten.bias"] = t(whiten["b"])
    net.load_state_dict({k: v.contiguous() for k, v in sd.items()})
    return net.to(device)

"""The DPT-Hybrid monocular depth net in PyTorch (counterpart of
depth_tools/dpt_jax.py): the omnidata checkpoint's layout
(``omnidata_dpt_depth_v2.ckpt``, backbone ``vitb_rn50_384``, readout
``project``, hooks 0, 1, 8, 11).

``DPTDepth`` is an ``nn.Module`` whose parameters carry the checkpoint's
own names and shapes (torch layout, OIHW convolutions), so a state dict
loads with ``load_state_dict``; its forward is functional, NCHW:

  ResNetV2-50 stem and three stages (weight-standardized convolutions with
    timm's dynamic SAME padding, GroupNorm(32), eps 1e-5): /4 (256 ch),
    /8 (512), /16 (1024);
  ViT-B/16 on the stage-2 features: 1x1 projection to 576 tokens + the class
    token + position embedding, 12 blocks (LayerNorm eps 1e-6, exact GELU);
    blocks 8 and 11 read out (class token concatenated, Linear + GELU),
    reshaped to 24x24 and projected (block 11 also 3x3 / 2 to 12x12);
  3x3 "scratch" convolutions to 256 channels, the RefineNet fusion cascade
    (x2 bilinear, align_corners=True), and the head conv -> x2 -> conv ->
    ReLU -> 1x1 -> ReLU: depth [B, 384, 384].

Input: [B, 3, 384, 384], normalized (x - 0.5) / 0.5.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device

VIT_DIM = 768
N_HEADS = 12
GRID = 24                       # 384 / 16
STAGE_BLOCKS = (3, 4, 9)
_BB = "pretrained.model.patch_embed.backbone"
_PM = "pretrained.model"


def param_spec() -> Iterator[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter in the checkpoint, in the order
    ``random_params`` draws them (that of depth_tools/dpt_jax.py)."""
    yield f"{_BB}.stem.conv.weight", (64, 3, 7, 7)
    yield f"{_BB}.stem.norm.weight", (64,)
    yield f"{_BB}.stem.norm.bias", (64,)
    chans = [(64, 64, 256), (256, 128, 512), (512, 256, 1024)]
    for s, nblk in enumerate(STAGE_BLOCKS):
        cin, mid, cout = chans[s]
        for m in range(nblk):
            pre = f"{_BB}.stages.{s}.blocks.{m}"
            ci = cin if m == 0 else cout
            if m == 0:
                yield f"{pre}.downsample.conv.weight", (cout, ci, 1, 1)
                yield f"{pre}.downsample.norm.weight", (cout,)
                yield f"{pre}.downsample.norm.bias", (cout,)
            for conv, shape, c in (("1", (mid, ci, 1, 1), mid), ("2", (mid, mid, 3, 3), mid),
                                   ("3", (cout, mid, 1, 1), cout)):
                yield f"{pre}.conv{conv}.weight", shape
                yield f"{pre}.norm{conv}.weight", (c,)
                yield f"{pre}.norm{conv}.bias", (c,)
    yield f"{_PM}.cls_token", (1, 1, VIT_DIM)
    yield f"{_PM}.pos_embed", (1, GRID * GRID + 1, VIT_DIM)
    yield f"{_PM}.patch_embed.proj.weight", (VIT_DIM, 1024, 1, 1)
    yield f"{_PM}.patch_embed.proj.bias", (VIT_DIM,)
    for i in range(12):
        pre = f"{_PM}.blocks.{i}"
        for n in ("norm1", "norm2"):
            yield f"{pre}.{n}.weight", (VIT_DIM,)
            yield f"{pre}.{n}.bias", (VIT_DIM,)
        yield f"{pre}.attn.qkv.weight", (3 * VIT_DIM, VIT_DIM)
        yield f"{pre}.attn.qkv.bias", (3 * VIT_DIM,)
        yield f"{pre}.attn.proj.weight", (VIT_DIM, VIT_DIM)
        yield f"{pre}.attn.proj.bias", (VIT_DIM,)
        yield f"{pre}.mlp.fc1.weight", (4 * VIT_DIM, VIT_DIM)
        yield f"{pre}.mlp.fc1.bias", (4 * VIT_DIM,)
        yield f"{pre}.mlp.fc2.weight", (VIT_DIM, 4 * VIT_DIM)
        yield f"{pre}.mlp.fc2.bias", (VIT_DIM,)
    yield f"{_PM}.norm.weight", (VIT_DIM,)
    yield f"{_PM}.norm.bias", (VIT_DIM,)
    for idx in (3, 4):
        pre = f"pretrained.act_postprocess{idx}"
        yield f"{pre}.0.project.0.weight", (VIT_DIM, 2 * VIT_DIM)
        yield f"{pre}.0.project.0.bias", (VIT_DIM,)
        yield f"{pre}.3.weight", (VIT_DIM, VIT_DIM, 1, 1)
        yield f"{pre}.3.bias", (VIT_DIM,)
    yield "pretrained.act_postprocess4.4.weight", (VIT_DIM, VIT_DIM, 3, 3)
    yield "pretrained.act_postprocess4.4.bias", (VIT_DIM,)
    for i, cin in ((1, 256), (2, 512), (3, VIT_DIM), (4, VIT_DIM)):
        yield f"scratch.layer{i}_rn.weight", (256, cin, 3, 3)
    for i in (1, 2, 3, 4):
        pre = f"scratch.refinenet{i}"
        for u in ("resConfUnit1", "resConfUnit2"):
            for c in ("conv1", "conv2"):
                yield f"{pre}.{u}.{c}.weight", (256, 256, 3, 3)
                yield f"{pre}.{u}.{c}.bias", (256,)
        yield f"{pre}.out_conv.weight", (256, 256, 1, 1)
        yield f"{pre}.out_conv.bias", (256,)
    for k, shape in ((0, (128, 256, 3, 3)), (2, (32, 128, 3, 3)), (4, (1, 32, 1, 1))):
        yield f"scratch.output_conv.{k}.weight", shape
        yield f"scratch.output_conv.{k}.bias", (shape[0],)


def convert_state_dict(sd) -> Dict[str, torch.Tensor]:
    """A checkpoint dict -> {name: float32 CPU tensor} in torch layout.
    A Lightning checkpoint ({'state_dict': {'model.<name>': ...}}) is
    unwrapped and its 6-character prefix dropped, as the reference does."""
    if "state_dict" in sd:
        sd = {k[6:]: v for k, v in sd["state_dict"].items()}
    return {k: v.detach().to("cpu", torch.float32) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """timm's dynamic SAME padding: the smaller half before, the larger
    after."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


class DPTDepth(nn.Module):
    """DPT-Hybrid depth (see the module docstring); parameters named as in
    the checkpoint, initialised to zeros (``build_dpt`` makes one holding a
    state dict)."""

    def __init__(self):
        super().__init__()
        for name, shape in param_spec():
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, nn.Parameter(torch.zeros(shape), requires_grad=False))

    def p(self, name: str) -> torch.Tensor:
        return self.get_parameter(name)

    def _conv(self, x, name, stride=1, padding=0, bias=True):
        return F.conv2d(x, self.p(f"{name}.weight"), self.p(f"{name}.bias") if bias else None,
                        stride=stride, padding=padding)

    def _std_conv(self, x, name, stride=1):
        """timm's StdConv2dSame: weights standardized over (I, H, W)
        (population variance, eps 1e-6), dynamic SAME padding, no bias."""
        w = self.p(f"{name}.weight")
        v, m = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (w - m) / torch.sqrt(v + 1e-6)
        return F.conv2d(_pad_same(x, w.shape[-1], stride), w, stride=stride)

    def _gn(self, x, name):
        return F.group_norm(x, 32, self.p(f"{name}.weight"), self.p(f"{name}.bias"), eps=1e-5)

    def _bottleneck(self, pre, x, stride):
        """timm's resnetv2 Bottleneck (not pre-activated)."""
        sc = x
        if hasattr(self.get_submodule(pre), "downsample"):
            sc = self._gn(self._std_conv(x, f"{pre}.downsample.conv", stride),
                          f"{pre}.downsample.norm")
        h = F.relu(self._gn(self._std_conv(x, f"{pre}.conv1"), f"{pre}.norm1"))
        h = F.relu(self._gn(self._std_conv(h, f"{pre}.conv2", stride), f"{pre}.norm2"))
        h = self._gn(self._std_conv(h, f"{pre}.conv3"), f"{pre}.norm3")
        return F.relu(h + sc)

    def _vit_block(self, pre, x):
        B, N, C = x.shape
        h = F.layer_norm(x, (C,), self.p(f"{pre}.norm1.weight"), self.p(f"{pre}.norm1.bias"),
                         eps=1e-6)
        qkv = F.linear(h, self.p(f"{pre}.attn.qkv.weight"), self.p(f"{pre}.attn.qkv.bias"))
        q, k, v = qkv.reshape(B, N, 3, N_HEADS, C // N_HEADS).permute(2, 0, 3, 1, 4)
        a = torch.softmax((q @ k.transpose(-2, -1)) * (C // N_HEADS) ** -0.5, dim=-1)
        h = (a @ v).transpose(1, 2).reshape(B, N, C)
        x = x + F.linear(h, self.p(f"{pre}.attn.proj.weight"), self.p(f"{pre}.attn.proj.bias"))
        h = F.layer_norm(x, (C,), self.p(f"{pre}.norm2.weight"), self.p(f"{pre}.norm2.bias"),
                         eps=1e-6)
        h = F.gelu(F.linear(h, self.p(f"{pre}.mlp.fc1.weight"), self.p(f"{pre}.mlp.fc1.bias")))
        return x + F.linear(h, self.p(f"{pre}.mlp.fc2.weight"), self.p(f"{pre}.mlp.fc2.bias"))

    def _reassemble(self, tok, pre):
        """Project readout (class token concatenated to every token, Linear +
        GELU), tokens to a 24x24 map, 1x1 conv."""
        B = tok.shape[0]
        h = torch.cat([tok[:, 1:], tok[:, :1].expand_as(tok[:, 1:])], dim=-1)
        h = F.gelu(F.linear(h, self.p(f"{pre}.0.project.0.weight"),
                            self.p(f"{pre}.0.project.0.bias")))
        h = h.transpose(1, 2).reshape(B, VIT_DIM, GRID, GRID)
        return self._conv(h, f"{pre}.3")

    def _fusion(self, pre, x, skip=None):
        """FeatureFusionBlock: [x + RCU(skip)], RCU, x2 bilinear
        (align_corners=True), 1x1 out_conv."""
        def rcu(u, h):
            o = self._conv(F.relu(h), f"{pre}.{u}.conv1", padding=1)
            return self._conv(F.relu(o), f"{pre}.{u}.conv2", padding=1) + h

        if skip is not None:
            x = x + rcu("resConfUnit1", skip)
        x = rcu("resConfUnit2", x)
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return self._conv(x, f"{pre}.out_conv")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, 384, 384] normalized -> depth [B, 384, 384] (>= 0)."""
        if x.shape[-2:] != (GRID * 16, GRID * 16):
            raise ValueError(f"DPT-Hybrid runs at 384x384, got {tuple(x.shape)}")
        h = F.relu(self._gn(self._std_conv(x, f"{_BB}.stem.conv", 2), f"{_BB}.stem.norm"))
        h = F.max_pool2d(_pad_same(h, 3, 2, float("-inf")), 3, 2)
        feats = []
        for s, nblk in enumerate(STAGE_BLOCKS):
            for m in range(nblk):
                h = self._bottleneck(f"{_BB}.stages.{s}.blocks.{m}", h,
                                     2 if (m == 0 and s > 0) else 1)
            feats.append(h)
        l1, l2, h = feats

        h = self._conv(h, f"{_PM}.patch_embed.proj")
        B = h.shape[0]
        tok = torch.cat([self.p(f"{_PM}.cls_token").expand(B, -1, -1),
                         h.flatten(2).transpose(1, 2)], dim=1) + self.p(f"{_PM}.pos_embed")
        for i in range(12):
            tok = self._vit_block(f"{_PM}.blocks.{i}", tok)
            if i == 8:
                l3 = tok
        l3 = self._reassemble(l3, "pretrained.act_postprocess3")
        l4 = self._conv(self._reassemble(tok, "pretrained.act_postprocess4"),
                        "pretrained.act_postprocess4.4", stride=2, padding=1)

        rn = [self._conv(lv, f"scratch.layer{i}_rn", padding=1, bias=False)
              for i, lv in ((1, l1), (2, l2), (3, l3), (4, l4))]
        path = self._fusion("scratch.refinenet4", rn[3])
        path = self._fusion("scratch.refinenet3", path, rn[2])
        path = self._fusion("scratch.refinenet2", path, rn[1])
        path = self._fusion("scratch.refinenet1", path, rn[0])

        h = self._conv(path, "scratch.output_conv.0", padding=1)
        h = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=True)
        h = F.relu(self._conv(h, "scratch.output_conv.2", padding=1))
        h = F.relu(self._conv(h, "scratch.output_conv.4"))
        return h[:, 0]


def build_dpt(state_dict: Dict[str, torch.Tensor], device="cuda") -> DPTDepth:
    """A DPTDepth on ``device`` holding ``state_dict`` (torch layout, the
    checkpoint's names; extra keys are ignored, a missing one raises)."""
    missing = [k for k, _ in param_spec() if k not in state_dict]
    if missing:
        raise KeyError(f"DPT state dict lacks {len(missing)} parameters, e.g. {missing[:3]}")
    with torch.device("meta"):                  # no storage until the state dict's is taken
        model = DPTDepth()
    model.load_state_dict({k: state_dict[k] for k, _ in param_spec()}, assign=True)
    return model.to(resolve_device(device)).eval().requires_grad_(False)


def load_dpt(path: str, device="cuda") -> DPTDepth:
    """The omnidata DPT-Hybrid depth checkpoint (.ckpt / .pth) at ``path``.
    ``torch.load`` unpickles it in full (a Lightning checkpoint holds more
    than tensors), as the reference loader does: load only a file you
    trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return build_dpt(convert_state_dict(ckpt), device)


def dpt_depth(model: DPTDepth, x: torch.Tensor) -> torch.Tensor:
    """Depth of x [B, 3, 384, 384] (normalized) -> [B, 384, 384]."""
    with torch.no_grad():
        return model(x)


def random_params(key=None, dtype=np.float32):
    """Random parameters in the checkpoint's layout, drawn from
    ``RandomState(key or 0)`` in the reference's order, so they equal
    depth_tools/dpt_jax.py's bit for bit: (converted tensors, raw numpy
    state dict)."""
    rng = np.random.RandomState(0 if key is None else key)
    sd = {name: (rng.randn(*shape) * 0.05).astype(dtype) for name, shape in param_spec()}
    return convert_state_dict(sd), sd

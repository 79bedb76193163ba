"""Plain float32 reference of the MultiDimStacker spotting model.

Written from the published architecture (lRomul/ball-action-spotting:
``src/models/multidim_stacker.py`` over timm's ``tf_efficientnetv2_b0``),
not from the program under test: plain ``torch`` calls on a flat state
dict whose keys follow the program's checkpoint layout. The encoder is
EfficientNetV2 with TF "SAME" padding and BatchNorm eps 1e-3; the 3D head
is four inverted-residual blocks (expand 1×1×1, depthwise 3×3×3 as a
grouped ``conv3d``, squeeze-excite, project 1×1×1, eps 1e-5), a per-stack
1×1 projection, GeM pooling (``mean(clamp(x, eps)^p)^(1/p)``) and a
linear classifier. Inference only: BN from its running statistics,
stochastic depth and dropout off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# name -> (stem channels, stages (kind, repeats, kernel, stride, expand,
# channels, se ratio)); EfficientNetV2-B0 (width and depth multipliers 1)
ARCHS = {
    "efficientnetv2_b0": (32, (
        ("cn", 1, 3, 1, 1, 16, 0.0),
        ("er", 2, 3, 2, 4, 32, 0.0),
        ("er", 2, 3, 2, 4, 48, 0.0),
        ("ir", 3, 3, 2, 4, 96, 0.25),
        ("ir", 5, 3, 1, 6, 112, 0.25),
        ("ir", 8, 3, 2, 6, 192, 0.25),
    )),
    # a small stand-in with the same stage kinds, for tests on the CPU
    "efficientnetv2_tiny": (8, (
        ("cn", 1, 3, 1, 1, 8, 0.0),
        ("er", 1, 3, 2, 2, 8, 0.0),
        ("er", 1, 3, 2, 2, 16, 0.0),
        ("ir", 1, 3, 2, 2, 16, 0.25),
        ("ir", 1, 3, 2, 2, 24, 0.25),
    )),
}
ENCODER_EPS = 1e-3
HEAD_EPS = 1e-5
GEM_EPS = 1e-6


def encoder_blocks(model_name: str) -> list[dict]:
    """The encoder's blocks up to stride 32, in order."""
    _, stages = ARCHS[model_name.replace("tf_", "").split(".")[0]]
    blocks, in_ch = [], ARCHS[model_name.replace("tf_", "").split(".")[0]][0]
    for si, (kind, reps, k, stride, expand, ch, se) in enumerate(stages):
        for r in range(reps):
            s = stride if r == 0 else 1
            blocks.append(dict(name=f"blocks_{si}_{r}", kind=kind, k=k, stride=s,
                               expand=expand, in_ch=in_ch, ch=ch, se=se,
                               skip=s == 1 and in_ch == ch))
            in_ch = ch
    return blocks


class Reference:
    """The model as functions of a state dict ``w`` (float32 tensors)."""

    def __init__(self, w: dict, kwargs: dict):
        self.w = w
        self.kw = kwargs
        self.blocks = encoder_blocks(kwargs["model_name"])

    # --- primitives -------------------------------------------------------

    def conv2d(self, x, weight, stride=1, groups=1, bias=None):
        k = weight.shape[-1]
        pads = []
        for size in (x.shape[-1], x.shape[-2]):  # F.pad order: W then H
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        if pads[0] == pads[1] and pads[2] == pads[3]:  # symmetric: the conv pads
            padding = (pads[2], pads[0])
        else:  # TF "SAME": the extra row and column at the bottom and right
            x, padding = F.pad(x, pads), 0
        return F.conv2d(x, weight, bias, stride, padding, 1, groups)

    def linear(self, x, weight, bias=None):
        return F.linear(x, weight.flatten(1), bias)

    def bn(self, x, prefix, eps, act, channel_dim):
        w = self.w
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        mean, var = w[prefix + ".running_mean"], w[prefix + ".running_var"]
        scale = torch.rsqrt(var.view(shape) + eps) * w[prefix + ".weight"].view(shape)
        y = (x - mean.view(shape)) * scale + w[prefix + ".bias"].view(shape)
        return F.silu(y) if act else y

    # --- encoder (NCHW) ----------------------------------------------------

    def encoder(self, x: torch.Tensor) -> torch.Tensor:
        """(B, stack, H, W) in [0, 1] → (B, h, w, C3d) projected features."""
        w, p = self.w, "conv2d_encoder."
        x = self.bn(self.conv2d(x, w[p + "conv_stem.weight"], 2), p + "bn1", ENCODER_EPS, True, 1)
        for b in self.blocks:
            n = p + b["name"] + "."
            if b["kind"] == "cn":
                out = self.bn(self.conv2d(x, w[n + "conv.weight"], b["stride"]), n + "bn1",
                              ENCODER_EPS, True, 1)
            elif b["kind"] == "er":
                out = self.bn(self.conv2d(x, w[n + "conv_exp.weight"], b["stride"]), n + "bn1",
                              ENCODER_EPS, True, 1)
                out = self.bn(self.conv2d(out, w[n + "conv_pwl.weight"]), n + "bn2",
                              ENCODER_EPS, False, 1)
            else:
                out = self.bn(self.conv2d(x, w[n + "conv_pw.weight"]), n + "bn1",
                              ENCODER_EPS, True, 1)
                mid = out.shape[1]
                out = self.bn(self.conv2d(out, w[n + "conv_dw.weight"], b["stride"], groups=mid),
                              n + "bn2", ENCODER_EPS, True, 1)
                se = out.mean((2, 3), keepdim=True)
                se = F.silu(self.conv2d(se, w[n + "se.conv_reduce.weight"],
                                        bias=w[n + "se.conv_reduce.bias"]))
                se = self.conv2d(se, w[n + "se.conv_expand.weight"],
                                 bias=w[n + "se.conv_expand.bias"])
                out = out * torch.sigmoid(se)
                out = self.bn(self.conv2d(out, w[n + "conv_pwl.weight"]), n + "bn3",
                              ENCODER_EPS, False, 1)
            if b["skip"]:
                out = out + x
            x = out
        x = x.permute(0, 2, 3, 1)
        x = self.linear(x, w["conv2d_projection_conv.weight"])
        return self.bn(x, "conv2d_projection_bn", HEAD_EPS, True, -1)

    # --- 3D head (channels last) ----------------------------------------------

    def block3d(self, x: torch.Tensor, i: int) -> torch.Tensor:
        w, n = self.w, f"conv3d_encoder_{i}."
        out = self.bn(self.linear(x, w[n + "conv_pw.weight"]), n + "bn1", HEAD_EPS, True, -1)
        c = out.shape[-1]
        dw = F.conv3d(out.permute(0, 4, 1, 2, 3), w[n + "conv_dw.weight"], None, 1, 1, 1, c)
        out = self.bn(dw.permute(0, 2, 3, 4, 1), n + "bn2", HEAD_EPS, True, -1)
        se = out.mean((1, 2, 3), keepdim=True)
        se = F.silu(self.linear(se, w[n + "se.conv_reduce.weight"], w[n + "se.conv_reduce.bias"]))
        se = self.linear(se, w[n + "se.conv_expand.weight"], w[n + "se.conv_expand.bias"])
        out = out * torch.sigmoid(se)
        out = self.bn(self.linear(out, w[n + "conv_pwl.weight"]), n + "bn3", HEAD_EPS, False, -1)
        return out + x

    def head(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, S, h, w, C3d) stack features → (B, classes) logits."""
        w = self.w
        b, s, h, wd, c = feats.shape
        x = feats
        for i in range(self.kw["num_3d_blocks"]):
            x = self.block3d(x, i)
        x = self.linear(x.reshape(b * s, h, wd, c), w["conv3d_projection_conv.weight"])
        x = self.bn(x, "conv3d_projection_bn", HEAD_EPS, True, -1)
        pw = w["global_pool.p"]
        pooled = x.clamp_min(GEM_EPS).pow(pw).mean((1, 2)).pow(1.0 / pw)  # (b·s, proj)
        return self.linear(pooled.reshape(b, -1), w["classifier.weight"], w["classifier.bias"])

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W) frames in [0, 1] → (B, classes) logits; stack j is
        frames [j·m, (j+1)·m) as channels."""
        b, t, h, wd = clips.shape
        m = self.kw["stack_size"]
        feats = self.encoder(clips.reshape(b * (t // m), m, h, wd))
        return self.head(feats.reshape((b, t // m) + feats.shape[1:]))


def num_stacks(kwargs: dict) -> int:
    return kwargs["num_frames"] // kwargs["stack_size"]


def model_shapes(kwargs: dict) -> dict:
    """{state key: shape} of the model's parameters and BN statistics."""
    shapes: dict = {}

    def bn(prefix, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{leaf}"] = (c,)

    stem, _ = ARCHS[kwargs["model_name"].replace("tf_", "").split(".")[0]]
    p = "conv2d_encoder."
    shapes[p + "conv_stem.weight"] = (stem, kwargs["stack_size"], 3, 3)
    bn(p + "bn1", stem)
    for b in encoder_blocks(kwargs["model_name"]):
        n, k, cin, ch = p + b["name"] + ".", b["k"], b["in_ch"], b["ch"]
        if b["kind"] == "cn":
            shapes[n + "conv.weight"] = (ch, cin, k, k)
            bn(n + "bn1", ch)
        elif b["kind"] == "er":
            mid = cin * b["expand"]
            shapes[n + "conv_exp.weight"] = (mid, cin, k, k)
            bn(n + "bn1", mid)
            shapes[n + "conv_pwl.weight"] = (ch, mid, 1, 1)
            bn(n + "bn2", ch)
        else:
            mid, rd = cin * b["expand"], max(1, int(cin * b["se"]))
            shapes[n + "conv_pw.weight"] = (mid, cin, 1, 1)
            bn(n + "bn1", mid)
            shapes[n + "conv_dw.weight"] = (mid, 1, k, k)
            bn(n + "bn2", mid)
            shapes[n + "se.conv_reduce.weight"] = (rd, mid, 1, 1)
            shapes[n + "se.conv_reduce.bias"] = (rd,)
            shapes[n + "se.conv_expand.weight"] = (mid, rd, 1, 1)
            shapes[n + "se.conv_expand.bias"] = (mid,)
            shapes[n + "conv_pwl.weight"] = (ch, mid, 1, 1)
            bn(n + "bn3", ch)
    enc_ch = encoder_blocks(kwargs["model_name"])[-1]["ch"]
    c3, proj = kwargs["num_3d_features"], kwargs["num_3d_stack_proj"]
    shapes["conv2d_projection_conv.weight"] = (c3, enc_ch, 1, 1)
    bn("conv2d_projection_bn", c3)
    mid = c3 * kwargs["expansion_3d_ratio"]
    rd = mid // kwargs["se_reduce_3d_ratio"]
    for i in range(kwargs["num_3d_blocks"]):
        n = f"conv3d_encoder_{i}."
        shapes[n + "conv_pw.weight"] = (mid, c3, 1, 1, 1)
        bn(n + "bn1", mid)
        shapes[n + "conv_dw.weight"] = (mid, 1, 3, 3, 3)
        bn(n + "bn2", mid)
        shapes[n + "se.conv_reduce.weight"] = (rd, mid, 1, 1, 1)
        shapes[n + "se.conv_reduce.bias"] = (rd,)
        shapes[n + "se.conv_expand.weight"] = (mid, rd, 1, 1, 1)
        shapes[n + "se.conv_expand.bias"] = (mid,)
        shapes[n + "conv_pwl.weight"] = (c3, mid, 1, 1, 1)
        bn(n + "bn3", c3)
    shapes["conv3d_projection_conv.weight"] = (proj, c3, 1, 1)
    bn("conv3d_projection_bn", proj)
    shapes["global_pool.p"] = (1,)
    shapes["classifier.weight"] = (kwargs["num_classes"], proj * num_stacks(kwargs))
    shapes["classifier.bias"] = (kwargs["num_classes"],)
    return shapes


def seeded_weights(kwargs: dict, seed: int, device) -> dict:
    """Seeded float32 weights made on ``device`` in one draw: conv and
    dense kernels normal at 1/√fan_in, BN scales and variances uniform in
    [0.5, 1.5], biases and means normal at 0.1, GeM p = 3."""
    shapes = model_shapes(kwargs)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) > 1:
            t = normal[at:at + n] / math.sqrt(n // shape[0])
        elif leaf in ("weight", "running_var"):
            t = 0.5 + uniform[at:at + n]
        elif leaf == "p":
            t = torch.full((n,), 3.0, device=device)
        else:
            t = normal[at:at + n] * 0.1
        out[key] = t.reshape(shape).clone()
        at += n
    return out


@torch.no_grad()
def calibrate_bn(w: dict, kwargs: dict, clips: torch.Tensor) -> None:
    """Set every BN's running statistics, in place in ``w``, to those of
    its input on ``clips`` (B, T, H, W) in [0, 1], in float32 with TF32
    off, so that the seeded network keeps its activations normalized and
    its outputs depend on the frames."""
    ref = Reference(w, kwargs)
    plain_bn = ref.bn

    def bn(x, prefix, eps, act, channel_dim):
        dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
        w[prefix + ".running_mean"].copy_(x.mean(dims))
        w[prefix + ".running_var"].copy_(x.var(dims, unbiased=False))
        return plain_bn(x, prefix, eps, act, channel_dim)

    ref.bn = bn
    with float32_exact():
        ref.forward(clips)


class float32_exact:
    """TF32 off for cuDNN and matmuls inside the block, restored after."""

    def __enter__(self):
        self._saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self._saved
        return False
